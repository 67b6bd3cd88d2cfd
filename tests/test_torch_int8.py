"""Weight-only int8 in the port against the JAX package, on the CPU.

`quantize_state_int8` (the serving PTQ rule) against the reference's on
llama_tiny states in f32 and bf16: the same keys quantized, codes and
scales bitwise. `incubate`'s `weight_quantize` / `weight_dequantize`
bitwise, and `weight_only_linear` (the W8A16 kernel's plain route) per
column and per group in f32 and bf16 against the reference's function.
The int8 engine (`quantize="int8"`) against the reference's int8 engine
on the reference's own scenario (tests/test_serving.py:223-257) and on
drafting traffic: greedy tokens identical on the ragged regime with
speculation armed (drafted and accepted equal) and on the bucketed
regime; and `serve --quantize int8` builds the engine."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenerationRequest as JReq
from paddle_tpu.inference.serving import quantize_state_int8 as j_quant
from paddle_tpu.models import llama as JL
import paddle_tpu_torch.incubate.nn.functional as TIF
from paddle_tpu_torch.inference import quantize_state_int8 as t_quant
from paddle_tpu_torch.inference import serve as t_serve
from paddle_tpu_torch.inference.serving import \
    ContinuousBatchingEngine as TEngine
from paddle_tpu_torch.inference.serving import GenerationRequest as TReq
from paddle_tpu_torch.inference.serving import _dequant_state
from paddle_tpu_torch.kernels import weight_only_linear as kwol
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import state_from_jax

from _torch_threads import one_torch_thread  # noqa: F401,E402

# the reference's serving tests' tiny LLaMA (tests/test_serving.py:13)
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128)
# the products of one decoder layer and the head, all >= 4096 elements
# at TINY and so quantized by the 4096 floor
PROJ = ("self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj",
        "mlp.down_proj")


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pair(dtype="float32", **cfg):
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(use_recompute=False,
                                            dtype=dtype, **cfg))
    np_state = {k: _np(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = TL.LlamaConfig(dtype=dtype, **cfg)
    tm = TL.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_from_jax(np_state, tcfg, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(**TINY)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_state_int8_bitwise(dtype):
    """The same keys quantized, int8 codes and f32 scales bitwise, on
    llama_tiny's state (the lm head quantized, embedding and norms
    not)."""
    jm, tm = _pair(dtype, vocab_size=1024, hidden_size=256,
                   intermediate_size=688, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=512)
    jq = j_quant({k: t.data for k, t in jm.state_dict().items()})
    tq = t_quant({k: v.detach() for k, v in tm.state_dict().items()})
    assert set(jq) == set(tq)
    jkeys = {k for k, v in jq.items() if isinstance(v, tuple)}
    tkeys = {k for k, v in tq.items() if isinstance(v, kwol.QuantWeight)}
    assert jkeys == tkeys
    assert "lm_head" in tkeys
    assert not any("embed" in k or "norm" in k for k in tkeys)
    for k in tkeys:
        jqv, jsv = jq[k]
        assert tq[k].q.dtype == torch.int8
        np.testing.assert_array_equal(tq[k].q.numpy(), np.asarray(jqv))
        assert tq[k].scale.dtype == torch.float32
        assert tuple(tq[k].scale.shape) == tuple(jsv.shape)
        np.testing.assert_array_equal(tq[k].scale.numpy(), np.asarray(jsv))
    for k in set(tq) - tkeys:
        assert isinstance(tq[k], torch.Tensor)


@pytest.mark.parametrize("algo,group", [("weight_only_int8", -1),
                                        ("weight_only_int4", -1),
                                        ("weight_only_int8", 64),
                                        ("weight_only_int4", 64)])
def test_weight_quantize_dequantize_bitwise(algo, group):
    """incubate's weight_quantize ([-128, 127] clip for int8, qmax 7
    for int4, group-wise [K/g, N] scales) and weight_dequantize, codes,
    scales and the dequantized weight bitwise."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 96)) * 0.05).astype(np.float32)
    w[5, 7] = 0.0                       # a clipped extreme stays in range
    jq, js = JIF.weight_quantize(paddle.to_tensor(w), algo=algo,
                                 group_size=group)
    tq, ts = TIF.weight_quantize(torch.from_numpy(w), algo=algo,
                                 group_size=group)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.numpy()))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    for out_dtype in ("float32", "bfloat16"):
        jd = JIF.weight_dequantize(jq, js, algo=algo, out_dtype=out_dtype,
                                   group_size=group)
        td = TIF.weight_dequantize(tq, ts, algo=algo, out_dtype=out_dtype,
                                   group_size=group)
        np.testing.assert_array_equal(td.float().numpy(), _np(jd.numpy()))


def test_weight_quantize_bad_group_raises():
    w = torch.zeros((100, 8))
    with pytest.raises(ValueError, match="group_size"):
        TIF.weight_quantize(w, group_size=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [-1, 64])
@pytest.mark.parametrize("bias", [False, True])
def test_weight_only_linear(dtype, group, bias):
    """weight_only_linear against the reference's: bitwise in f32 and in
    bf16 (the plain route repeats the reference's float order: scale
    and codes cast to the activation dtype, the product, then the
    bias)."""
    rng = np.random.default_rng(4)
    K, N = 128, 80
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((3, 5, K)).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, js = JIF.weight_quantize(paddle.to_tensor(w), group_size=group)
    tq, ts = TIF.weight_quantize(torch.from_numpy(w), group_size=group)
    jx = paddle.to_tensor(jnp.asarray(x, jdt))
    tx = torch.from_numpy(x).to(tdt)
    jb = paddle.to_tensor(jnp.asarray(b, jdt)) if bias else None
    tb = torch.from_numpy(b).to(tdt) if bias else None
    jo = JIF.weight_only_linear(jx, jq, jb, js, group_size=group)
    to = TIF.weight_only_linear(tx, tq, tb, ts, group_size=group)
    assert to.dtype == tdt
    np.testing.assert_array_equal(to.float().numpy(), _np(jo.numpy()))
    if group == -1 and not bias:
        # llm_int8_linear lowers to weight_only_linear, as the reference
        lo = TIF.llm_int8_linear(tx, tq, None, ts)
        np.testing.assert_array_equal(lo.float().numpy(),
                                      _np(JIF.llm_int8_linear(
                                          jx, jq, None, js).numpy()))


def test_quantized_projections_at_tiny(tiny):
    """At the reference scenario's size every layer's four products and
    the lm head are int8 in the engine's state, and the embedding and
    norms are not."""
    _, tm = tiny
    eng = TEngine(tm, max_batch=1, max_seq=64, quantize="int8",
                  device="cpu")
    assert eng._quantized
    for i in range(TINY["num_hidden_layers"]):
        for n in PROJ:
            w = eng.state[f"model.layers.{i}.{n}"]
            assert isinstance(w, kwol.QuantWeight), n
            assert w.q.dtype == torch.int8
            assert tuple(w.scale.shape) == (1, w.q.shape[1])
        for n in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            assert isinstance(eng.state[f"model.layers.{i}.{n}"],
                              torch.Tensor)
    assert isinstance(eng.state["lm_head"], kwol.QuantWeight)
    assert isinstance(eng.state["model.embed_tokens"], torch.Tensor)
    for wl in eng._wls:
        assert isinstance(wl["self_attn.qkv_proj"], kwol.QuantWeight)
        assert isinstance(wl["mlp.gate_up_proj"], kwol.QuantWeight)


def _drive(eng, req_cls, prompts, max_new):
    reqs = [req_cls(list(p), max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    for r in reqs:
        eng.add_request(r)
    ticks = 0
    while eng.has_work and ticks < 2000:
        eng.step()
        ticks += 1
    assert not eng.has_work
    return reqs


def _motif(seed, tail):
    rng = np.random.RandomState(seed)
    motif = rng.randint(1, 128, 12).tolist()
    return motif + motif + rng.randint(1, 128, tail).tolist()


@pytest.mark.parametrize("regime", ["ragged_spec", "bucketed"])
def test_int8_engine_matches_reference(tiny, regime):
    """The port's int8 engine against the reference's int8 engine:
    greedy tokens identical on the reference's scenario (one slot,
    prompt [5, 17, 42, 7], 5 new tokens, bucket 8) and on two drafting
    streams beside it; on the ragged regime with speculation armed the
    drafted and accepted counts are equal too."""
    jm, tm = tiny
    ragged = regime != "bucketed"
    knobs = dict(max_seq=64, prefill_buckets=(8,), quantize="int8",
                 ragged=ragged, speculative=ragged, slo=False,
                 request_trace=False)
    for prompts, n_new, B in (([[5, 17, 42, 7]], [5], 1),
                              ([_motif(1, 3), _motif(2, 5)], [12, 9], 2)):
        je = JEngine(jm, max_batch=B, **knobs)
        te = TEngine(tm, max_batch=B, device="cpu", **knobs)
        jr = _drive(je, JReq, prompts, n_new)
        tr = _drive(te, TReq, prompts, n_new)
        assert [r.output for r in tr] == [r.output for r in jr]
        assert all(len(r.output) == n for r, n in zip(tr, n_new))
        if ragged:
            assert te._spec and je._spec
            assert (te.spec_drafted, te.spec_accepted) == (
                je.spec_drafted, je.spec_accepted)
            if B == 2:
                assert te.spec_drafted > 0


def test_int8_engine_equals_dequantized_engine(tiny):
    """The reference's own parity method, in the port: the int8 engine's
    tokens equal a full-precision engine's over the dequantized weights
    (`_dequant_state`), on both regimes."""
    _, tm = tiny
    prompts, n_new = [_motif(3, 4), [5, 17, 42, 7]], [10, 6]
    for ragged in (True, False):
        q8 = TEngine(tm, max_batch=2, max_seq=64, prefill_buckets=(8,),
                     quantize="int8", ragged=ragged, device="cpu")
        deq = TL.LlamaForCausalLM(tm.cfg, device="cpu")
        deq.load_state_dict(_dequant_state(q8.state, q8.dtype))
        ref = TEngine(deq, max_batch=2, max_seq=64, prefill_buckets=(8,),
                      ragged=ragged, device="cpu")
        assert ([r.output for r in _drive(q8, TReq, prompts, n_new)]
                == [r.output for r in _drive(ref, TReq, prompts, n_new)])


def test_unported_quantize_raises(tiny):
    _, tm = tiny
    with pytest.raises(NotImplementedError, match="not ported"):
        TEngine(tm, max_batch=1, max_seq=64, quantize="int4", device="cpu")


def test_serve_builds_an_int8_engine(tiny, tmp_path, monkeypatch):
    """`serve --quantize int8` parses and builds the int8 engine (the
    CLI's own argument path, up to the gateway)."""
    from paddle_tpu_torch.inference import gateway as t_gw
    _, tm = tiny
    prefix = str(tmp_path / "m")
    t_gw.save_for_serving(tm, prefix)
    built = {}

    class _Stop(Exception):
        pass

    def fake_gateway(*a, runner=None, **k):
        built["engine"] = runner.engine
        raise _Stop

    monkeypatch.setattr(t_gw, "ServingGateway", fake_gateway)
    with pytest.raises(_Stop):
        t_serve.main(["--model", prefix, "--device", "cpu", "--port", "0",
                      "--quantize", "int8", "--max-batch", "1",
                      "--max-seq", "64"])
    eng = built["engine"]
    assert eng._quantized
    assert isinstance(eng.state["lm_head"], kwol.QuantWeight)
