#!/usr/bin/env python
"""Launch a ``mxnet_tpu_torch`` serving endpoint, or a whole fleet of them.

The PyTorch port's counterpart of ``tools/serve.py``.  Models come from:

* ``--model name=path/prefix[:epoch]``: a ``HybridBlock.export`` file
  triple (symbol, params, signature sidecar);
* ``--zoo name=resnet18_v1[:CxHxW]``: a fresh vision model-zoo network
  (random weights from ``--seed``);
* ``--llm name=FACTORY[:K=V,...]``: a language-zoo decoder served with
  paged-KV continuous batching (``POST /generate/<name>``), its weights
  drawn from ``--seed`` so every process that builds the same spec holds
  the same weights; ``--draft`` adds a speculative draft.

One process serves one ``--role`` (``mixed``, ``prefill`` or ``decode``;
warmup captures only the role's CUDA graph family before the socket
binds).  ``--replicas N`` or ``--roles prefill:1,decode:2`` runs the fleet
instead: N children of this command under a
:class:`~mxnet_tpu_torch.fleet.ReplicaManager` with its supervisor armed,
behind a prefix-aware :class:`~mxnet_tpu_torch.fleet.Router` on
``--host``/``--port``.  ``--device`` defaults to ``cuda``; pass ``cpu`` to
run without a card.

Examples::

    python tools/serve_torch.py --llm lm=llama_7b --layers 4 --port 8001
    python tools/serve_torch.py --llm lm=llama_7b --dtype bfloat16 \\
        --roles prefill:1,decode:2 --port 8000
    python tools/serve_torch.py --device cpu --replicas 2 \\
        --llm lm=llama_tiny:vocab_size=53,max_length=64
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROLES = ("mixed", "prefill", "decode")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="mxnet_tpu_torch serving endpoint or fleet")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=PREFIX[:EPOCH]",
                   help="serve an exported artifact (repeatable)")
    p.add_argument("--zoo", action="append", default=[],
                   metavar="NAME=FACTORY[:CxHxW]",
                   help="serve a vision model-zoo net with random weights "
                        "(repeatable); shape defaults to 3x224x224")
    p.add_argument("--llm", action="append", default=[],
                   metavar="NAME=FACTORY[:K=V,...]",
                   help="serve a language-zoo decoder (repeatable), e.g. "
                        "lm=llama_tiny:vocab_size=53,max_length=64")
    p.add_argument("--draft", default=None, metavar="FACTORY[:K=V,...]",
                   help="draft decoder enabling speculative decoding for "
                        "every --llm model")
    p.add_argument("--slots", type=int, default=4,
                   help="continuous-batching slots per --llm model")
    p.add_argument("--max-length", type=int, default=None,
                   help="longest prompt + budget a --llm model admits "
                        "(default: its RoPE table); sizes the page pool")
    p.add_argument("--warmup-prompt-len", type=int, default=None,
                   help="longest prompt the warmup captures for "
                        "(default: --max-length)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16", "float16"),
                   help="weights' dtype for --llm models (and its pool)")
    p.add_argument("--layers", type=int, default=None,
                   help="override the --llm factory's layer count")
    p.add_argument("--seed", type=int, default=0,
                   help="weights of --llm and --zoo models")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-us", type=int, default=2000)
    p.add_argument("--classes", type=int, default=1000,
                   help="output classes for --zoo nets")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warmup (first-seen signatures capture "
                        "inside live requests)")
    p.add_argument("--role", default="mixed", choices=ROLES,
                   help="disaggregation role of this process (fleet "
                        "children set it)")
    p.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="fleet mode: spawn N replica processes of this "
                        "command and serve a Router on --host/--port")
    p.add_argument("--roles", default=None, metavar="ROLE:N[,ROLE:N...]",
                   help="fleet role spec, e.g. prefill:1,decode:2 "
                        "(default: all --replicas are mixed)")
    return p


def _value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def build_llm(spec: str, device: str = "cuda", dtype: str = "float32",
              layers=None, seed: int = 0):
    """A language-zoo decoder from a ``factory[:k=v,...]`` spec, its
    weights from ``seed``: every process building the same spec on the
    same device type holds the same weights."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo import language
    from mxnet_tpu_torch.initializer import initialize
    from mxnet_tpu_torch.random import generator
    factory, _, kvs = spec.partition(":")
    if not hasattr(language, factory):
        raise SystemExit(f"unknown language-zoo factory {factory!r}")
    kwargs = {}
    for part in filter(None, kvs.split(",")):
        k, _, v = part.partition("=")
        kwargs[k.strip()] = _value(v.strip())
    if layers is not None:
        kwargs["num_layers"] = int(layers)
    model = getattr(language, factory)(device=device,
                                       dtype=getattr(torch, dtype), **kwargs)
    initialize(model, generator(seed, device))
    return model.eval().requires_grad_(False)


def build_generation(args, llm_spec: str, name: str):
    """The GenerationScheduler a ``--llm`` spec serves (shared with
    ``tools/chaos_torch.py``'s in-process oracle)."""
    from mxnet_tpu_torch.serving import GenerationScheduler
    model = build_llm(llm_spec, args.device, args.dtype, args.layers,
                      args.seed)
    draft = (build_llm(args.draft, args.device, args.dtype, None,
                       args.seed + 1) if args.draft else None)
    return GenerationScheduler(model, max_slots=args.slots,
                               max_length=args.max_length, draft_model=draft,
                               name=name)


def _parse_roles(args):
    if args.roles:
        roles = []
        for part in args.roles.split(","):
            role, _, n = part.partition(":")
            role = role.strip()
            if role not in ROLES:
                raise SystemExit(f"--roles expects mixed/prefill/decode, "
                                 f"got {role!r}")
            roles.extend([role] * int(n or 1))
        return roles
    return ["mixed"] * args.replicas


def _child_argv(args, role: str, port: int):
    """This command for one replica child: the same models, the child's
    role and port, never the fleet flags."""
    argv = [sys.executable, os.path.abspath(__file__),
            "--host", args.host, "--port", str(port), "--role", role,
            "--slots", str(args.slots), "--max-batch", str(args.max_batch),
            "--max-wait-us", str(args.max_wait_us),
            "--classes", str(args.classes), "--device", args.device,
            "--dtype", args.dtype, "--seed", str(args.seed)]
    for flag in ("max_length", "warmup_prompt_len", "layers", "draft"):
        if getattr(args, flag) is not None:
            argv += ["--" + flag.replace("_", "-"), str(getattr(args, flag))]
    for flag in ("model", "zoo", "llm"):
        for spec in getattr(args, flag):
            argv += [f"--{flag}", spec]
    if args.no_warmup:
        argv += ["--no-warmup"]
    return argv


def _sigterm_drains():
    """SIGTERM stops the serving loop the way Ctrl-C does, so the process
    drains its accepted requests before it exits."""
    def handler(signum, frame):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, handler)


def _main_fleet(args) -> int:
    from mxnet_tpu_torch.fleet import ReplicaManager, Router

    roles = _parse_roles(args)
    manager = ReplicaManager(lambda role, port: _child_argv(args, role, port),
                             roles, host=args.host)
    print(f"fleet: spawning {len(roles)} replica(s) {roles} ...", flush=True)
    t0 = time.time()
    router = None
    try:
        manager.start(wait_ready=True)
        router = Router(manager.endpoints())
        # the supervisor respawns dead or DEGRADED replicas (same port,
        # crash-loop backoff); its stats render under GET /fleet
        manager.start_supervisor()
        router.attach_supervisor(manager.supervisor_stats)
        host, port = router.start_http(args.host, args.port)
        print(f"fleet: router on http://{host}:{port} over "
              f"{[r.url for r in manager.replicas]} "
              f"(ready in {time.time() - t0:.1f}s; POST /generate/<name>, "
              f"GET /fleet)", flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("fleet: draining...", flush=True)
    finally:
        if router is not None:
            router.stop()
        manager.stop()
    return 0


def _split_spec(spec: str, what: str):
    if "=" not in spec:
        raise SystemExit(f"--{what} expects NAME=VALUE, got {spec!r}")
    return spec.split("=", 1)


def _register_models(server, args):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import InferenceEngine

    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    n = 0
    for spec in args.model:
        name, rest = _split_spec(spec, "model")
        prefix, _, epoch = rest.partition(":")
        engine = InferenceEngine.from_export(prefix, epoch=int(epoch or 0),
                                             ctx=ctx,
                                             max_batch=args.max_batch,
                                             name=name)
        server.register(name, engine=engine, max_wait_us=args.max_wait_us,
                        warmup=not args.no_warmup)
        n += 1
    for spec in args.zoo:
        name, rest = _split_spec(spec, "zoo")
        factory, _, shape = rest.partition(":")
        from mxnet_tpu_torch.gluon.model_zoo import vision
        if not hasattr(vision, factory):
            raise SystemExit(f"unknown model-zoo factory {factory!r}")
        mx.random.seed(args.seed)
        net = getattr(vision, factory)(classes=args.classes, ctx=ctx)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        feat = tuple(int(d) for d in (shape or "3x224x224").split("x"))
        server.register(name, net, max_batch=args.max_batch,
                        max_wait_us=args.max_wait_us,
                        input_spec=[(feat, "float32")],
                        warmup=not args.no_warmup)
        n += 1
    for spec in args.llm:
        name, rest = _split_spec(spec, "llm")
        server.register_generation(
            name, None, scheduler=build_generation(args, rest, name),
            warmup=not args.no_warmup,
            warmup_prompt_len=args.warmup_prompt_len)
        n += 1
    if not n:
        raise SystemExit("nothing to serve: pass --model, --zoo and/or "
                         "--llm")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _sigterm_drains()
    if args.replicas or args.roles:
        return _main_fleet(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but no CUDA card is visible; "
                             "pass --device cpu")
    from mxnet_tpu_torch.serving import ModelServer

    server = ModelServer(role=args.role)
    t0 = time.time()
    try:
        _register_models(server, args)
        port = server.start_http(args.host, args.port)
        print(f"serving {server.models()} ({args.role}, {args.device}) on "
              f"http://{args.host}:{port} (warmup {time.time() - t0:.1f}s; "
              f"POST /generate/<name>, /predict/<name>, GET /ping)",
              flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("draining...", flush=True)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
