"""Port serving engine and gateway (paddle_tpu_torch.inference) against
the JAX engine, on llama_tiny in fp32 on the CPU: the JAX engine runs
with request_trace=False (a kill switch that is bitwise in the
reference) and speculation and the SLO layer armed, as the port's
default engine arms them, or both with speculative=False, slo=False;
the port with the same scheduler knobs; greedy outputs must be
token-identical tick for tick."""
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import router as j_router
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import gateway as t_gw
from paddle_tpu_torch.inference import router as t_router
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax

from _torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(dtype="float32",
                                           use_recompute=False))
    np_state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = TL.llama_tiny(dtype="float32")
    tm = TL.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, cfg, "cpu"))
    return jm, tm


def _mixed_workload():
    """(tick to submit at, prompt, max_new): a decoding request, a long
    prompt chunked while it decodes, then two prompts sharing a 2-page
    (32-token) prefix."""
    rng = np.random.RandomState(7)
    prefix = rng.randint(1, 1024, 32).tolist()
    return [(0, [5, 17, 3], 20),
            (3, rng.randint(1, 1024, 30).tolist(), 5),
            (4, prefix + [11, 12, 13], 4),
            (12, prefix + [21, 22], 4)]


def _drive(engine, req_cls, workload, max_ticks=400):
    reqs = []
    trace = []
    tick = 0
    todo = list(workload)
    while (todo or engine.has_work) and tick < max_ticks:
        while todo and todo[0][0] <= tick:
            _, prompt, n = todo.pop(0)
            r = req_cls(list(prompt), max_new_tokens=n)
            engine.add_request(r)
            reqs.append(r)
        engine.step()
        trace.append((engine.last_packed_tokens, engine.preemptions))
        tick += 1
    assert not engine.has_work
    return reqs, trace


@pytest.mark.parametrize("spec", ["default", "kill_switch"])
@pytest.mark.parametrize("scenario", ["mixed_chunk_prefix", "preempt"])
def test_engine_token_identical_to_jax(models, scenario, spec):
    """The port's default engine (no speculative / slo / request_trace
    argument: speculation and the SLO layer armed, the tracing flag at
    the reference's kill switch) against the JAX engine's default built
    with request_trace=False; and both with speculative=False,
    slo=False: token- and tick-identical."""
    jm, tm = models
    if scenario == "preempt":
        knobs = dict(max_batch=2, max_seq=64, total_pages=5,
                     max_chunk_tokens=8)
        workload = [(0, [11, 5], 38), (0, [7, 19], 38)]
    else:
        knobs = dict(max_batch=2, max_seq=64, max_chunk_tokens=8)
        workload = _mixed_workload()
    off = {} if spec == "default" else {"speculative": False, "slo": False}
    je = JEngine(jm, request_trace=False, **knobs, **off)
    te = TEngine(tm, device="cpu", **knobs, **off)
    assert te._spec == je._spec == (spec == "default")
    assert te._slo == je._slo == (spec == "default")
    jreqs, jtrace = _drive(je, JReq, workload)
    treqs, ttrace = _drive(te, TReq, workload)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.status for r in treqs] == ["served"] * len(workload)
    assert ttrace == jtrace
    assert (te.spec_drafted, te.spec_accepted) == (je.spec_drafted,
                                                   je.spec_accepted)
    assert te.prefill_tokens_total == je.prefill_tokens_total
    assert te.preemptions == je.preemptions
    assert te.quarantines == je.quarantines == 0
    assert te.pool.n_free == te.pool.n_pages - 1
    if scenario == "preempt":
        assert te.preemptions >= 1
    else:
        assert te._pcache.hits == je._pcache.hits >= 1
        assert max(p for p, _ in ttrace) > 1      # chunk packed w/ decode


def test_chain_key_bit_identical():
    rng = np.random.RandomState(3)
    parent = b""
    for n in (1, 7, 16, 16):
        toks = rng.randint(0, 1 << 40, n).tolist()
        want = j_router.chain_key(parent, toks)
        assert t_router.chain_key(parent, toks) == want
        parent = want


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode()


def test_serve_cli_streams_engine_tokens(models, tmp_path):
    _, tm = models
    prefix = str(tmp_path / "tiny")
    t_gw.save_for_serving(tm, prefix)
    prompt = [9, 4, 2, 8, 1, 77]
    eng = TEngine(tm, max_batch=2, max_seq=64, max_chunk_tokens=8,
                  device="cpu")
    ref = TReq(list(prompt), max_new_tokens=6)
    eng.run([ref])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
         "--model", prefix, "--device", "cpu", "--port", "0",
         "--max-batch", "2", "--max-seq", "64", "--max-chunk-tokens", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), line
        port = int(line.split("http://", 1)[1].split()[0].rsplit(":", 1)[1])
        body = _post(port, {"prompt": prompt, "max_new_tokens": 6})
        toks, end = [], None
        for frame in body.split("\n\n"):
            if frame.startswith("data: "):
                toks.extend(json.loads(frame[6:])["tokens"])
            elif frame.startswith("event: end"):
                end = json.loads(frame.split("data: ", 1)[1])
        # the terminal frame names the request's trace (tracing is armed
        # by default)
        tid = end.pop("trace_id")
        assert len(tid) == 32 and int(tid, 16) >= 0
        assert end == {"status": "served", "n_tokens": 6}
        assert toks == ref.output
        doc = json.loads(_post(port, {"prompt": prompt,
                                      "max_new_tokens": 6,
                                      "stream": False}))
        assert len(doc.pop("trace_id")) == 32
        assert doc == {"status": "served", "output": ref.output}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["accepting"]
        assert health["engine"]["kv_pages"]["free"] == \
            health["engine"]["kv_pages"]["total"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        assert "drained, bye" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_engine_fault_fails_open_streams(models):
    """An engine-level fault on the tick thread ends every open stream
    with an error frame and turns the gateway unready — no client is
    left waiting on keepalives."""
    _, tm = models
    eng = TEngine(tm, max_batch=2, max_seq=64, device="cpu")

    def boom():
        raise RuntimeError("boom")

    eng.step = boom
    gateway = t_gw.ServingGateway(t_gw.EngineRunner(eng), port=0)
    port = gateway.start()
    try:
        body = _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 2})
        assert "event: error" in body and "engine fault: boom" in body
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 2})
        assert err.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=30)
        assert err.value.code == 503
    finally:
        gateway.stop()


# ------------------------------------------------ serving defaults


@pytest.mark.parametrize("flag", ["FLAGS_serving_slo", "FLAGS_request_trace",
                                  "FLAGS_lock_witness"])
def test_unported_serving_flags_raise(models, flag, monkeypatch):
    """The reference arms the SLO layer and request tracing by default.
    Both are ported: each flag defaults on and arms its feature, and 0
    is the kill switch. The lock witness is not ported: set in the
    environment, it asks for a feature the engine refuses."""
    from paddle_tpu_torch.framework import core as t_core
    _, tm = models
    if flag == "FLAGS_lock_witness":
        monkeypatch.setenv(flag, "1")
        with pytest.raises(NotImplementedError, match="not ported"):
            TEngine(tm, max_batch=2, max_seq=64, device="cpu")
        return
    attr = "_slo" if flag == "FLAGS_serving_slo" else "_rtrace"
    assert t_core.get_bool_flag(flag)
    assert getattr(TEngine(tm, max_batch=2, max_seq=64, device="cpu"), attr)
    monkeypatch.setitem(t_core._flags, flag, 0)
    assert not getattr(TEngine(tm, max_batch=2, max_seq=64, device="cpu"),
                       attr)


@pytest.mark.parametrize("knob,value", [
    ("slo", True), ("request_trace", True), ("max_queue_tokens", 100),
    ("quantize", "int8")])
def test_unported_engine_knobs_raise(models, knob, value):
    """quantize="int8" arms int8 weights (another mode raises); the SLO
    layer's arguments arm it, and request_trace arms tracing."""
    _, tm = models
    if knob == "quantize":
        assert TEngine(tm, max_batch=2, max_seq=64, device="cpu",
                       **{knob: value})._quantized
        with pytest.raises(NotImplementedError, match="not ported"):
            TEngine(tm, max_batch=2, max_seq=64, device="cpu",
                    quantize="int4")
        return
    eng = TEngine(tm, max_batch=2, max_seq=64, device="cpu", **{knob: value})
    if knob == "request_trace":
        assert eng._rtrace
        return
    assert eng._slo
    assert eng.max_queue_tokens == (value if knob == "max_queue_tokens"
                                    else None)


def test_gateway_refuses_priority_and_deadline(models):
    """The gateway takes `priority` and `deadline_s` and refuses only a
    value that does not parse (400, the server keeps serving): a
    priority-2 request is served, and a deadline that has passed before
    the first tick answers 504 with DeadlineExceeded."""
    _, tm = models
    eng = TEngine(tm, max_batch=2, max_seq=64, device="cpu")
    eng.add_request(TReq([1, 2, 3], max_new_tokens=2, priority=1))
    assert eng.waiting[0].priority == 1
    eng.waiting.clear()
    gateway = t_gw.ServingGateway(t_gw.EngineRunner(eng), port=0)
    port = gateway.start()
    try:
        for extra in ({"priority": "high"}, {"deadline_s": "soon"}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 2,
                             **extra})
            assert err.value.code == 400
            assert "priority/eos_token_id/deadline_s" in json.loads(
                err.value.read())["error"]
        doc = json.loads(_post(port, {"prompt": [1, 2, 3],
                                      "max_new_tokens": 2, "priority": 2,
                                      "stream": False}))
        assert doc["status"] == "served" and len(doc["output"]) == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 2,
                         "deadline_s": 1e-9, "stream": False})
        assert err.value.code == 504
        body = json.loads(err.value.read())
        assert body["status"] == "deadline_missed"
        assert "DeadlineExceeded" in body["error"]
    finally:
        gateway.stop()
