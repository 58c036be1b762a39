"""The port's fleet across real processes, on the CPU: a
``ReplicaManager`` spawning ``tools/serve_torch.py --device cpu``
children, the Router's socket data plane, a SIGKILL mid-stream and the
supervisor's respawn on the same port.

The children build the port's llama_tiny (vocab 53, max_length 64, 4
layers) from seed 0; the oracle is the JAX package's ``greedy_decode`` on
those weights, copied into a JAX llama_tiny.  The tier-1 case bounds
every wait and takes under 30 s; the chaos harness
(``tools/chaos_torch.py``) and the disaggregated fleet are heavier and
carry the ``slow`` marker.
"""
import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.language import llama_tiny as jax_llama_tiny
from mxnet_tpu.serving import greedy_decode as jax_greedy_decode
from mxnet_tpu_torch.convert import _mxnet_suffix
from mxnet_tpu_torch.fleet import ReplicaManager, Router
from mxnet_tpu_torch.serving import Client

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import serve_torch  # noqa: E402
import chaos_torch  # noqa: E402

VOCAB, MAXLEN, LAYERS = 53, 64, 4
SPEC = f"lm=llama_tiny:vocab_size={VOCAB},max_length={MAXLEN}"
ARGS = serve_torch.build_parser().parse_args(
    ["--llm", SPEC, "--device", "cpu", "--slots", "2",
     "--layers", str(LAYERS), "--warmup-prompt-len", "16"])
ENV = {"OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _command_for(role, port):
    return serve_torch._child_argv(ARGS, role, port)


@pytest.fixture(scope="module")
def jnet():
    """A JAX llama_tiny holding the children's weights."""
    port = serve_torch.build_llm(SPEC.split("=", 1)[1], "cpu", "float32",
                                 LAYERS, 0)
    jmx.random.seed(0)
    net = jax_llama_tiny(vocab_size=VOCAB, max_length=MAXLEN,
                         num_layers=LAYERS)
    net.collect_params().initialize()
    params = net.collect_params()
    prefix = next(k for k in params
                  if k.endswith("tok_embed_weight"))[:-len("tok_embed_weight")]
    copied = 0
    for key, value in port.state_dict().items():
        name = prefix + _mxnet_suffix(key)
        if name in params:
            params[name].set_data(jmx.nd.array(value.numpy()))
            copied += 1
    assert copied == len(params)
    return net


def _oracle(jnet, prompt, max_new):
    return jax_greedy_decode(jnet, prompt, max_new_tokens=max_new,
                             max_length=MAXLEN)


def _serving(url):
    try:
        with urllib.request.urlopen(url + "/ping", timeout=2) as r:
            return json.loads(r.read() or b"{}").get("status") == "SERVING"
    except Exception:  # noqa: BLE001 - down or still warming
        return False


def test_sigkill_mid_stream_migrates_and_supervisor_respawns(jnet):
    """Two CPU children behind the Router; the replica carrying a live
    stream is SIGKILLed after its first token: the stream ends with the
    JAX greedy tokens (no gap, no duplicate, no error), and the
    supervisor brings the victim back SERVING on its port, where it
    serves the same tokens."""
    t0 = time.monotonic()
    manager = ReplicaManager(_command_for, ["mixed", "mixed"],
                             ready_timeout=25.0, env=ENV)
    router = None
    try:
        manager.start(wait_ready=True)
        manager.start_supervisor(poll_s=0.2, dead_after=2, base_backoff=0.1,
                                 max_backoff=1.0, stable_s=600.0,
                                 ready_timeout=25.0)
        router = Router(manager.endpoints(), poll_s=0.25)
        host, port = router.start_http("127.0.0.1", 0)
        prompt = np.random.RandomState(7).randint(1, VOCAB, 6).tolist()
        max_new = MAXLEN - len(prompt)
        stream = Client(f"http://{host}:{port}").generate_stream(
            "lm", prompt, max_new_tokens=max_new)
        got = [next(stream)]
        job = next(iter(router._jobs.values()))
        victim = next(i for i, r in enumerate(manager.replicas)
                      if r.url == job.rep.url)
        port0, pid0 = manager.replicas[victim].port, \
            manager.replicas[victim].proc.pid
        manager.kill(victim)
        got += list(stream)
        assert got == _oracle(jnet, prompt, max_new)
        assert router.migrations >= 1
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not (
                manager.replicas[victim].proc.pid != pid0
                and _serving(manager.replicas[victim].url)):
            time.sleep(0.1)
        rep = manager.replicas[victim]
        assert rep.proc.pid != pid0 and rep.port == port0
        assert _serving(rep.url)
        stats = manager.supervisor_stats()
        assert stats["restarts"] >= 1
        assert stats["recent"][0]["port"] == port0
        router.refresh()
        router.replicas[1 - victim].cordoned = True   # the respawn serves
        short = prompt[:4]
        code, body = router.route_generate(
            "lm", {"prompt": short, "max_new_tokens": 5})
        assert code == 200 and body["tokens"] == _oracle(jnet, short, 5)
    finally:
        if router is not None:
            router.stop()
        manager.stop()
    assert time.monotonic() - t0 < 30.0


@pytest.mark.slow
def test_chaos_harness_on_cpu():
    """tools/chaos_torch.py's gates on CPU children: 16 streams, 2 seeded
    SIGKILLs with the supervisor armed."""
    report = chaos_torch.run_chaos(
        llm=SPEC, device="cpu", layers=LAYERS, requests=16, max_new=24,
        kills=2, kill_wait_s=30.0, ready_timeout_s=60.0)
    assert report["ok"], report
    assert len(report["kills_done"]) == 2


@pytest.mark.slow
def test_disaggregated_processes_match_jax(jnet):
    """prefill:1,decode:1 across processes: the K/V crosses the wire and
    the tokens are the JAX greedy tokens."""
    manager = ReplicaManager(_command_for, ["prefill", "decode"],
                             ready_timeout=60.0, env=ENV)
    try:
        manager.start(wait_ready=True)
        router = Router(manager.endpoints())
        assert router._disaggregated()
        prompt = np.random.RandomState(3).randint(1, VOCAB, 9).tolist()
        code, body = router.route_generate(
            "lm", {"prompt": prompt, "max_new_tokens": 5})
        assert code == 200 and body["tokens"] == _oracle(jnet, prompt, 5)
    finally:
        manager.stop()
