#!/usr/bin/env python
"""Seeded fleet chaos harness for the PyTorch port.

The counterpart of ``tools/chaos.py``: open-loop *streaming* traffic
through a :class:`~mxnet_tpu_torch.fleet.Router` over
``tools/serve_torch.py`` replica processes, with replicas SIGKILLed at
seeded points and the :class:`~mxnet_tpu_torch.fleet.ReplicaManager`
supervisor armed.  Gates:

* **zero failed requests**: every stream ends with its ``done`` event
  (kills are absorbed by live migration);
* **token parity**: every stream's tokens equal an in-process greedy
  oracle, a paged scheduler over the same seeded weights on the same
  device (so no gap and no duplicate slipped through);
* **fleet restored**: every replica is alive and SERVING again after the
  storm, on its original port;
* **bounded p99**: ``p99_chaos <= p99_baseline * p99_bound + p99_grace_s``
  (a migration costs a reconnect and a re-prefill or snapshot attach);
* **no new CachedOp entry**: every replica's entries after the storm
  equal its count right after its warmup, so a survivor captured nothing
  under traffic and a respawned replica was warmed (its whole family
  captured) before it answered ``/ping`` and was routed to.  CUDA graphs
  do not outlive a process, so a respawn re-captures; the JAX package's
  "zero recompiles" gate over its persistent compile cache has no
  counterpart here.

Before each kill the harness waits up to ``--kill-wait-s`` for two
SERVING replicas (the supervisor may still be warming the previous
victim); a kill that finds fewer is skipped, as in ``tools/chaos.py``.
On a card it samples each child's ``GET /goodput`` every half second
and reports each child process's peak allocated device memory.
``--faults "relay=unavailable*2"`` layers FaultPlan injections on the
router process.

Examples::

    python tools/chaos_torch.py --device cpu --requests 16 --kills 2
    python tools/chaos_torch.py --llm lm=llama_7b --layers 4 \\
        --max-length 128 --kill-wait-s 120 --json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=10) as resp:
        return json.loads(resp.read() or b"{}")


def _ping_status(url: str):
    try:
        return _get(url, "/ping").get("status")
    except Exception:  # noqa: BLE001 - down counts as not SERVING
        return None


def _entries(url: str, model: str):
    """The replica's CachedOp entries for ``model`` (None when down)."""
    try:
        return int(_get(url, f"/stats/{model}")["compile_cache"]["entries"])
    except Exception:  # noqa: BLE001 - down: the restore gate fails
        return None


def _pctl(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def _parse_faults(spec: str):
    """``site=kind*N,site=kind`` -> FaultPlan mapping."""
    plan = {}
    for part in spec.split(","):
        site, _, kinds = part.partition("=")
        plan.setdefault(site.strip(), []).append(kinds.strip())
    return plan


class _MemorySampler:
    """Each replica process's peak allocated device memory (GB), read from
    its ``GET /goodput`` every ``period`` seconds while running; keyed by
    ``replica index:pid``, so a respawn is a row of its own."""

    def __init__(self, manager, period: float = 0.5):
        self.peak = {}
        self._manager = manager
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        args=(period,))

    def _loop(self, period):
        while not self._stop.wait(period):
            for i, rep in enumerate(list(self._manager.replicas)):
                try:
                    dev = _get(rep.url, "/goodput").get("device_memory")
                except Exception:  # noqa: BLE001 - down or warming
                    continue
                if dev:
                    key = f"{i}:{rep.proc.pid}"
                    self.peak[key] = max(self.peak.get(key, 0.0),
                                         dev["peak_allocated_bytes"] / 1e9)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(15)


def run_chaos(llm: str = "lm=llama_tiny:vocab_size=53,max_length=64",
              device: str = "cuda", dtype: str = "float32", layers=None,
              max_length=None, slots: int = 2,
              replicas: int = 2, requests: int = 16, max_new: int = 24,
              kills: int = 2, seed: int = 0, interarrival_s: float = 0.15,
              kill_wait_s: float = 0.0, p99_bound: float = 10.0,
              p99_grace_s: float = 5.0, restore_timeout_s: float = 300.0,
              ready_timeout_s: float = 600.0, faults: str = None,
              log=lambda *_: None) -> dict:
    """One chaos run; returns the report (``report["ok"]`` is the AND of
    every gate in the module docstring)."""
    import numpy as np

    import serve_torch
    from mxnet_tpu_torch.fleet import ReplicaManager, Router
    from mxnet_tpu_torch.resilience import FaultPlan
    from mxnet_tpu_torch.serving import Client

    if replicas < 2:
        raise SystemExit("chaos needs >= 2 replicas (a kill must always "
                         "leave a migration survivor)")
    name, _, spec = llm.partition("=")
    serve_args = serve_torch.build_parser().parse_args(
        ["--llm", llm, "--device", device, "--dtype", dtype,
         "--seed", str(seed), "--slots", str(slots)]
        + (["--layers", str(layers)] if layers is not None else [])
        + (["--max-length", str(max_length)] if max_length else []))

    def command_for(role, port):
        return serve_torch._child_argv(serve_args, role, port)

    # the oracle: the children's scheduler, built the same way in this
    # process, each unique prompt decoded alone
    log("chaos: building the in-process oracle ...")
    oracle_sched = serve_torch.build_generation(serve_args, spec,
                                                f"{name}-oracle")
    vocab = oracle_sched.model.tok_embed.num_embeddings
    rng = np.random.RandomState(seed)
    system = rng.randint(1, vocab, 16).tolist()
    prompts = [system + rng.randint(1, vocab, 6).tolist()
               for _ in range(requests)]
    if len(prompts[0]) + max_new > oracle_sched.max_length:
        raise SystemExit(f"prompt {len(prompts[0])} + max_new {max_new} "
                         f"exceeds max_length {oracle_sched.max_length}")
    oracle = {}
    for p in prompts:
        if tuple(p) not in oracle:
            fut = oracle_sched.submit(p, max_new_tokens=max_new, eos_id=None)
            oracle_sched.run()
            oracle[tuple(p)] = fut.result(timeout=0)
    del oracle_sched

    log(f"chaos: spawning {replicas} replica(s) ...")
    manager = ReplicaManager(command_for, ["mixed"] * replicas,
                             ready_timeout=ready_timeout_s)
    router = None
    sampler = _MemorySampler(manager) if device == "cuda" else None
    report = {"llm": llm, "device": device, "dtype": dtype,
              "layers": layers, "replicas": replicas, "requests": requests,
              "max_new": max_new, "kills_requested": kills, "seed": seed,
              "p99_bound": p99_bound, "p99_grace_s": p99_grace_s}
    try:
        if sampler is not None:
            sampler.__enter__()
        t_spawn = time.perf_counter()
        manager.start(wait_ready=True)
        report["spawn_ready_s"] = time.perf_counter() - t_spawn
        ports0 = [r.port for r in manager.replicas]
        entries0 = [_entries(r.url, name) for r in manager.replicas]
        manager.start_supervisor(poll_s=0.5, dead_after=2,
                                 ready_timeout=ready_timeout_s)
        router = Router(manager.endpoints(), poll_s=0.5)
        host, port = router.start_http("127.0.0.1", 0)
        url = f"http://{host}:{port}"
        kills_done = []

        def _serving():
            return [i for i, r in enumerate(manager.replicas)
                    if r.alive() and _ping_status(r.url) == "SERVING"]

        def _kill_one(at_request):
            """Seeded SIGKILL of a replica that leaves a SERVING survivor;
            waits up to kill_wait_s for two, skips the kill otherwise."""
            deadline = time.monotonic() + kill_wait_s
            serving = _serving()
            while len(serving) < 2 and time.monotonic() < deadline:
                time.sleep(0.25)
                serving = _serving()
            if len(serving) < 2:
                log(f"chaos: kill@req{at_request} skipped "
                    f"(only {len(serving)} SERVING)")
                return
            victim = int(serving[rng.randint(len(serving))])
            pid = manager.replicas[victim].proc.pid
            manager.kill(victim)
            kills_done.append({"at_request": at_request, "replica": victim,
                               "pid": pid})
            log(f"chaos: SIGKILL replica {victim} (pid {pid}) "
                f"@ request {at_request}")

        def drive(phase, kill_at=()):
            """Stream i starts at i * interarrival (after any kill before
            it); returns (sorted latencies, failures, diverged ids)."""
            lat = [0.0] * len(prompts)
            failures, diverged = [], []
            lock = threading.Lock()

            def one(i, p):
                t0 = time.perf_counter()
                try:
                    toks = list(Client(url).generate_stream(
                        name, p, max_new_tokens=max_new, eos_id=None))
                except Exception as exc:  # noqa: BLE001 - counted by a gate
                    with lock:
                        failures.append((i, f"{type(exc).__name__}: {exc}"))
                    return
                lat[i] = time.perf_counter() - t0
                if toks != oracle[tuple(p)]:
                    with lock:
                        diverged.append(i)

            threads = []
            t0 = time.perf_counter()
            for i, p in enumerate(prompts):
                wait = i * interarrival_s - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(wait)
                if i in kill_at:
                    _kill_one(i)
                th = threading.Thread(target=one, args=(i, p))
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
            log(f"chaos: {phase} phase done ({len(failures)} failed, "
                f"{len(diverged)} diverged)")
            return sorted(v for v in lat if v), failures, diverged

        base_lat, base_fail, base_bad = drive("baseline")
        base_p99 = _pctl(base_lat, 0.99)
        pids_warm = [r.proc.pid for r in manager.replicas]

        kill_at = {max(1, (j + 1) * requests // (kills + 1))
                   for j in range(kills)}
        plan = FaultPlan(_parse_faults(faults)) if faults else None
        if plan is not None:
            plan.__enter__()
        try:
            chaos_lat, chaos_fail, chaos_bad = drive("chaos", kill_at)
        finally:
            if plan is not None:
                plan.__exit__(None, None, None)
        chaos_p99 = _pctl(chaos_lat, 0.99)

        # the supervisor must restore the fleet, on its original ports
        deadline = time.time() + restore_timeout_s
        restored = False
        while time.time() < deadline and not restored:
            restored = (len(_serving()) == replicas and
                        [r.port for r in manager.replicas] == ports0)
            if not restored:
                time.sleep(0.5)
        entries = [_entries(r.url, name) for r in manager.replicas]
        respawned = [r.proc.pid != pid0
                     for r, pid0 in zip(manager.replicas, pids_warm)]
        no_new_entries = all(e is not None and e == e0 and e0 > 0
                             for e, e0 in zip(entries, entries0))
        stats = manager.supervisor_stats()
        p99_ok = chaos_p99 <= base_p99 * p99_bound + p99_grace_s
        report.update({
            "kills_done": kills_done,
            "baseline_failed": len(base_fail) + len(base_bad),
            "baseline_p99_s": base_p99,
            "chaos_failed": len(chaos_fail),
            "chaos_parity_diverged": len(chaos_bad),
            "chaos_p99_s": chaos_p99,
            "p99_ok": p99_ok,
            "fleet_restored": restored,
            "ports": [r.port for r in manager.replicas],
            "supervisor_restarts": stats["restarts"],
            "supervisor_recent": stats["recent"],
            "entries_after_warmup": entries0,
            "entries_after_chaos": entries,
            "respawned": respawned,
            "no_new_entries": no_new_entries,
            "migrations": router.migrations,
            "hedges_won": router.hedges_won,
            "hedges_lost": router.hedges_lost,
            "router_cancelled": router.cancelled,
            "failures": (base_fail + chaos_fail)[:8],
            "faults": faults,
        })
        report["ok"] = bool(
            not base_fail and not base_bad and not chaos_fail
            and not chaos_bad and restored and p99_ok and no_new_entries
            and len(kills_done) >= 1)
        return report
    finally:
        if router is not None:
            router.stop()
        manager.stop()
        if sampler is not None:
            sampler.__exit__(None, None, None)
            report["peak_device_gb_by_replica_pid"] = sampler.peak


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="seeded fleet chaos harness for mxnet_tpu_torch: "
                    "open-loop streaming traffic + SIGKILLs")
    p.add_argument("--llm", default="lm=llama_tiny:vocab_size=53,"
                                    "max_length=64",
                   metavar="NAME=FACTORY[:K=V,...]")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16", "float16"))
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--max-length", type=int, default=None)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--kills", type=int, default=2)
    p.add_argument("--seed", type=int, default=0,
                   help="the children's weights, the traffic and the kill "
                        "points")
    p.add_argument("--interarrival-s", type=float, default=0.15)
    p.add_argument("--kill-wait-s", type=float, default=0.0,
                   help="seconds a kill waits for two SERVING replicas")
    p.add_argument("--p99-bound", type=float, default=10.0,
                   help="chaos p99 must be <= baseline p99 * BOUND + grace")
    p.add_argument("--p99-grace-s", type=float, default=5.0)
    p.add_argument("--faults", default=None, metavar="SITE=KIND[*N][,...]",
                   help="FaultPlan injections in the router process, e.g. "
                        "relay=unavailable*2,route=deadline")
    p.add_argument("--json", action="store_true",
                   help="print only the JSON report")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = ((lambda *_: None) if args.json else
           (lambda *a: print(*a, flush=True)))
    report = run_chaos(
        llm=args.llm, device=args.device, dtype=args.dtype,
        layers=args.layers,
        max_length=args.max_length, slots=args.slots,
        replicas=args.replicas, requests=args.requests, max_new=args.max_new,
        kills=args.kills, seed=args.seed, interarrival_s=args.interarrival_s,
        kill_wait_s=args.kill_wait_s, p99_bound=args.p99_bound,
        p99_grace_s=args.p99_grace_s, faults=args.faults, log=log)
    print(json.dumps(report, indent=None if args.json else 2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
