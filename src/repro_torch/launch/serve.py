"""Serving entry point of the port: EN-T w8a8 continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        [--engine] --quantize [--shared-prefix N] [--no-prefix-cache] \\
        [--cache-kind auto|dense|ring|paged] [--prefill-chunk N] \\
        [--draft-arch ARCH --spec-k K \\
        --spec-mode match|rejection] [--smoke] [--device cuda|cpu] \\
        [--num-layers N] [--param-dtype float32|bfloat16] \\
        [--http [--port P] [--host H] [--pipeline-depth D] [--max-queue Q] \\
         [--http-smoke] [--fault-plan NAME|seeded:N] [--max-retries R] \\
         [--watchdog S]]

Builds the model at the config's widths (``--smoke``: the reduced
config), draws random weights from ``--seed`` on the device and encodes
every projection into packed EN-T planes layer by layer
(``--quantize``).  Without ``--engine`` it runs the one-shot
``generate``: ``--batch`` random prompts of ``--prompt-len`` tokens,
``--steps`` new tokens each (``--cache-kind``: auto picks the ring for a
sliding-window model and dense rows otherwise; ``--prefill-chunk`` splits
the prefill).  With ``--engine`` it serves ``2 * --batch`` ragged
requests through the ``ServeEngine`` (auto: the ring for a
sliding-window model, paged otherwise), with the
radix prefix cache unless ``--no-prefix-cache``; ``--shared-prefix N``
puts one seeded N-token prefix in front of every request (a system
prompt).  ``--draft-arch`` turns speculative decoding on with ``--spec-k``
drafts a tick: the same arch as ``--arch`` is a weight-shared drafter
(the target's own model and params), another arch a float drafter with
random weights from ``--seed + 1``.  SSM and hybrid archs (mamba2-370m,
jamba-1.5-large) serve with their SSM layers' states beside the
attention caches (prefix caching off), MoE archs (mixtral-8x7b,
dbrx-132b) with float routers and experts.  ``--num-layers`` cuts the
depth and ``--param-dtype bfloat16`` stores the float weights in bf16
(the experts are cast to the compute dtype before every product, so a
bf16 model computes the same): all 32 layers of mixtral-8x7b need ~96
GB in bf16, so one card serves it with ``--num-layers 16 --param-dtype
bfloat16``.  Runs on the CUDA card unless ``--device cpu``.

``--http`` puts the async front end on top (implies ``--engine``): a
``PipelinedScheduler`` at ``--pipeline-depth`` driving the engine and the
stdlib HTTP/SSE server (``POST /v1/completions`` streams tokens, ``GET
/metrics``, ``GET /healthz``).  ``--http-smoke`` runs a scripted client
against the live server instead of blocking: one streamed completion
(the SSE stream must equal its final event), ``/healthz`` 200,
``/metrics`` with ``leaks_clean`` and one finished request, a clean
shutdown.  ``--fault-plan`` (a registered name such as ``ci-chaos``, or
``seeded:<n>``) serves under a deterministic fault plan; with it the
smoke also asserts that every fired fault was counted and none
quarantined a request.  ``--max-retries`` and ``--watchdog`` turn the
fault-tolerant ticks on.  On the card the CUDA libraries are built and
loaded before the scheduler's first tick, so no ``nvcc`` run lands
inside a watched tick.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model, build_model
from repro_torch.runtime.serve_loop import ServeEngine, generate


def build(cfg: ModelConfig, *, quantize: bool = False, seed: int = 0,
          device=None, use_kernels: bool = True, quant: QuantConfig | None = None,
          kv_quant: bool = False) -> tuple[Model, dict]:
    """Model + random params drawn on the device from ``seed``, quantized
    layer by layer with ``quant`` (``quantize``: EN-T, the default
    ``QuantConfig(enabled=True)``; ``QuantConfig(enabled=True,
    ent_encode=False)`` keeps plain w8a8 int8 records).  ``kv_quant``
    serves from an int8 KV cache."""
    dev = resolve_device(device)
    if quant is None and quantize:
        quant = QuantConfig(enabled=True)
    model = build_model(cfg, device=dev, use_kernels=use_kernels, kv_quant=kv_quant)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, quant=quant)
    return model, params


def ragged_prompts(rng: np.random.Generator, n: int, lo: int, hi: int,
                   vocab: int) -> list[list[int]]:
    """``n`` prompts with lengths drawn from [lo, hi] and random tokens."""
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(k)).tolist() for k in lens]


def serve(engine: ServeEngine, prompts, *, max_new_tokens: int,
          temperature: float = 0.0):
    """Submit ``prompts`` and drain the engine.  Returns (results
    {uid: tokens}, seconds) with the device synchronised."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new_tokens, temperature=temperature)
    results = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return results, time.perf_counter() - t0


def _resolve_plan(spec: str):
    """--fault-plan value -> FaultPlan: a registered name ("ci-chaos") or
    "seeded:<n>"."""
    from repro_torch.runtime.faults import FaultPlan

    if spec.startswith("seeded:"):
        return FaultPlan.seeded(int(spec.split(":", 1)[1]))
    return FaultPlan.named(spec)


def _smoke_client(host: str, port: int, prompt, steps: int):
    """The scripted client of ``--http-smoke``: one streamed completion,
    then ``/healthz`` and ``/metrics``.  Returns (streamed tokens, the
    metrics document)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    conn.request("POST", "/v1/completions",
                 json.dumps({"tokens": prompt, "max_new_tokens": steps}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, f"completions: HTTP {resp.status}"
    events = [json.loads(line[6:]) for line in resp.read().decode().splitlines()
              if line.startswith("data: ")]
    conn.close()
    assert events and events[-1].get("done"), "SSE stream did not finish"
    streamed = [e["token"] for e in events[:-1]]
    assert streamed == events[-1]["tokens"], "stream/final token mismatch"
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("GET", "/healthz")
    hz = conn.getresponse()
    assert hz.status == 200, f"healthz: HTTP {hz.status}"
    hz.read()
    conn.request("GET", "/metrics")
    m = json.loads(conn.getresponse().read())
    conn.close()
    return streamed, m


def serve_http(args, cfg, engine) -> dict | None:
    """--http: scheduler + SSE server.  With --http-smoke, runs the scripted
    client (under the --fault-plan plan when one is given), asserts what
    the reference's smoke asserts, shuts down, and returns {"tokens",
    "metrics", "fired"}; without, serves until interrupted."""
    from repro_torch.runtime.scheduler import PipelinedScheduler
    from repro_torch.runtime.server import ServingServer

    if engine.device.type == "cuda":
        from repro_torch.kernels import _build
        _build.load_all()     # no nvcc run inside a (watched) tick
    plan = _resolve_plan(args.fault_plan) if args.fault_plan else None
    retries = args.max_retries
    if plan is not None and retries == 0:
        retries = 3     # a chaos plan without a retry budget just dies
        print(f"fault plan {plan.name} active: defaulting --max-retries to {retries}")
    sched = PipelinedScheduler(engine, pipeline_depth=args.pipeline_depth,
                               max_queue=args.max_queue,
                               prefill_chunk=args.prefill_chunk or None,
                               max_retries=retries, watchdog_timeout=args.watchdog or None)
    srv = ServingServer(sched, host=args.host, port=args.port)
    if plan is not None:
        plan.activate()
    try:
        host, port = srv.start()
        print(f"serving http://{host}:{port} (backend={engine.cache_kind}, "
              f"slots={engine.slots}, depth={sched.depth}, device={engine.device})",
              flush=True)
        if not args.http_smoke:
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
            return None
        prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                   args.prompt_len).tolist()
        streamed, m = _smoke_client(host, port, prompt, args.steps)
        assert m["leaks_clean"], "allocator leak after completion"
        assert m["requests"]["finished"] == 1, m["requests"]
        fired = list(plan.fired) if plan is not None else []
        if plan is not None:
            assert fired, "fault plan active but no fault fired"
            assert m["faults"]["quarantined"] == 0, \
                f"chaos smoke quarantined a request: {sched.errors}"
            assert m["faults"]["total"] == len(fired), (m["faults"], fired)
    finally:
        srv.stop()
        if plan is not None:
            plan.deactivate()
    engine.check_leaks()
    ttft, itl = m["ttft"], m["inter_token"]
    chaos = (f", {len(fired)} faults injected ({m['faults']['retries']} retries, all "
             "recovered)") if plan is not None else ""
    print(f"http smoke: {len(streamed)} tokens streamed, ttft p50 {ttft['p50_us']}us, "
          f"itl p50 {itl['p50_us']}us / p99 {itl['p99_us']}us, 0 leaks{chaos}")
    return {"tokens": streamed, "metrics": m, "fired": fired}


def run_generate(args, cfg, model, params):
    """The one-shot path: ``--batch`` random prompts of ``--prompt-len``
    tokens (seed ``--seed``) through ``generate``.  Returns the [B,
    steps] tokens on the host."""
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    dev = model.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.steps, temperature=args.temperature,
                   seed=args.seed, prefill_chunk=args.prefill_chunk or None,
                   top_k=args.top_k or None, top_p=args.top_p or None,
                   cache_kind=None if args.cache_kind == "auto" else args.cache_kind)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {args.batch}x{args.steps} tokens in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")
    print("sample:", out[0, :16].tolist())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching ServeEngine over a ragged request "
                         "stream (requests = 2x --batch); without it, one generate()")
    ap.add_argument("--quantize", action="store_true",
                    help="EN-T w8a8: encode weights once, serve int8")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="radix prefix cache + copy-on-write page sharing "
                         "(default: auto, on for paged attention-only models)")
    ap.add_argument("--cache-kind", default="auto", choices=["auto", "dense", "ring", "paged"],
                    help="KV-cache backend (auto: the ring for sliding-window archs; "
                         "else paged for the engine, dense rows for generate)")
    ap.add_argument("--draft-arch", default="", choices=[""] + list(ARCH_IDS),
                    help="speculative decoding: drafter arch (same arch = "
                         "weight-shared drafter)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per slot per tick")
    ap.add_argument("--spec-mode", default="match", choices=["match", "rejection"],
                    help="'match' emits the plain engine's stream; 'rejection' "
                         "is classic rejection sampling")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one common N-token prefix (seeded) to every "
                         "request (exercises prefix sharing)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the depth to N layers (a multiple of the layer group; "
                         "default: the config's)")
    ap.add_argument("--param-dtype", default="", choices=["", "float32", "bfloat16"],
                    help="dtype of the float weights (default: the config's)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=0,
                    help="engine batch slots (default: --batch)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: prompts in chunks of this many tokens "
                         "(0 = one shot, or the ring's width)")
    ap.add_argument("--page-size", type=int, default=0)
    ap.add_argument("--pages", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP/SSE: PipelinedScheduler + stdlib asyncio "
                         "server (implies --engine)")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP port (0 = ephemeral, printed on bind)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="decode ticks dispatched ahead of the host")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission control: shed (429) past this depth")
    ap.add_argument("--http-smoke", action="store_true",
                    help="scripted client against the live server, then a clean "
                         "shutdown and leak check")
    ap.add_argument("--fault-plan", default="",
                    help="serve under a deterministic fault plan: a registered name "
                         "(e.g. 'ci-chaos') or 'seeded:<n>' (needs --http)")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="fault tolerance: per-request retry budget; nonzero turns "
                         "snapshot / rollback ticks on (3 when --fault-plan is set)")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    help="fault tolerance: per-tick watchdog timeout in seconds "
                         "(0 = off)")
    args = ap.parse_args(argv)
    if args.fault_plan and not args.http:
        ap.error("--fault-plan needs --http: only the fault-tolerant scheduler can "
                 "recover from injected faults")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.num_layers:
        if args.num_layers % len(cfg.group):
            ap.error(f"--num-layers must be a multiple of {cfg.name}'s layer group "
                     f"({len(cfg.group)})")
        cfg = replace(cfg, num_layers=args.num_layers)
    if args.param_dtype:
        cfg = replace(cfg, param_dtype=args.param_dtype)
    t0 = time.perf_counter()
    model, params = build(cfg, quantize=args.quantize, seed=args.seed,
                          device=args.device)
    print(f"model {cfg.name} on {model.device}: init"
          f"{' + EN-T encode' if args.quantize else ''} "
          f"{time.perf_counter() - t0:.2f}s")
    if not (args.engine or args.http):
        return run_generate(args, cfg, model, params)
    slots = args.slots or args.batch
    spec_kw = {}
    if args.draft_arch:
        if args.draft_arch == args.arch:   # weight-shared drafter
            dmodel, dparams = model, params
        else:
            dcfg = get_config(args.draft_arch)
            if args.smoke:
                dcfg = reduced_config(dcfg)
            dmodel, dparams = build(dcfg, seed=args.seed + 1, device=args.device)
        spec_kw = dict(draft_model=dmodel, draft_params=dparams, spec_k=args.spec_k,
                       spec_mode=args.spec_mode)
    engine = ServeEngine(
        model, params, slots=slots,
        max_len=2 * args.prompt_len + args.steps + 8 + args.shared_prefix,
        prefill_chunk=args.prefill_chunk or None, top_k=args.top_k or None,
        top_p=args.top_p or None, page_size=args.page_size or None,
        pages=args.pages or None, seed=args.seed, cache_kind=args.cache_kind,
        prefix_cache="auto" if args.prefix_cache is None else args.prefix_cache,
        **spec_kw)
    if args.http:
        return serve_http(args, cfg, engine)
    rng = np.random.default_rng(args.seed)
    prompts = ragged_prompts(rng, 2 * args.batch, max(1, args.prompt_len // 2),
                             args.prompt_len, cfg.vocab_size)
    lens = [len(p) for p in prompts]
    prefix = rng.integers(0, cfg.vocab_size, args.shared_prefix).tolist()
    prompts = [prefix + p for p in prompts]
    results, dt = serve(engine, prompts, max_new_tokens=args.steps,
                        temperature=args.temperature)
    total = sum(len(v) for v in results.values())
    print(f"engine[{engine.cache_kind}]: served {len(prompts)} ragged requests (prompt lens "
          f"{min(lens)}..{max(lens)}"
          + (f" after a {args.shared_prefix}-token shared prefix" if args.shared_prefix else "")
          + f") on {slots} slots: {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    if args.draft_arch:
        st, rate = engine.spec_stats, engine.acceptance_rate
        print(f"spec[k={args.spec_k}, {args.spec_mode}]: {st['ticks']} ticks, "
              f"{st['drafted']} drafted, {st['accepted']} accepted "
              f"({0.0 if rate is None else rate:.2%}), {st['emitted']} emitted "
              f"({st['emitted'] / max(st['ticks'], 1):.2f} tok/tick)")
    ps = engine.page_stats
    if ps is not None:
        print(f"pages: {ps['total']} total, {ps['free']} free, {ps['resident']} resident, "
              f"{ps['shared']} shared, {ps.get('cached', 0)} cached")
    kv = engine.pool_bytes - engine.ssm_bytes
    print(f"KV {'pools' if ps is not None else 'rows'} {kv / 2**20:.2f} MiB"
          + (f", SSM states {engine.ssm_bytes / 2**20:.2f} MiB" if engine.ssm_bytes else ""))
    fs = engine.prefix_stats
    if fs is not None:
        print(f"prefix cache: {fs['hits']}/{fs['lookups']} hits ({fs['hit_rate']:.0%}), "
              f"{fs['hit_tokens']} prompt tokens reused, {fs['resident']} pages cached, "
              f"{fs['evicted']} evicted, {fs['cow_copies']} copy-on-write copies")
    print("sample:", results[min(results)][:16])


if __name__ == "__main__":
    main()
