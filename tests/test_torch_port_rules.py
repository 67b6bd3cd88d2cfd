"""Rules the PyTorch/CUDA port keeps: it imports neither JAX nor the JAX
package, its entry points never fall back to the CPU on their own, it
refuses what is not ported yet, and chip_smoke.py fails without a card
(and outside the repo)."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as TL

from _torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "paddle_tpu")


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_jax_imports_ast():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {m}" for m in mods
                    if _forbidden(m)]
    assert len(_port_files()) > 10
    assert bad == []


def test_no_jax_in_sys_modules_after_import():
    code = (
        "import sys, pkgutil, importlib, paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,"
        " 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu')"
        " or m.startswith(('jax.', 'paddle_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def _tiny():
    return TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32"), device="cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32"))
    ContinuousBatchingEngine(model, device="cpu")       # explicit CPU runs


@pytest.mark.parametrize("layer", ["FusedLinear", "FusedMultiHeadAttention",
                                   "FusedTransformerEncoderLayer",
                                   "FusedEcMoe"])
def test_incubate_layers_need_a_card_unless_cpu_is_asked(layer):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from paddle_tpu_torch.incubate import nn as inn
    args = {"FusedLinear": (8, 8), "FusedMultiHeadAttention": (8, 2),
            "FusedTransformerEncoderLayer": (8, 2, 16),
            "FusedEcMoe": (8, 16, 2)}[layer]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(inn, layer)(*args)
    getattr(inn, layer)(*args, device="cpu")        # explicit CPU builds


@pytest.mark.parametrize("knob", [
    {"speculative": True}, {"slo": True},
    {"request_trace": True}, {"quantize": "int8"},
    {"max_queue_tokens": 512}],
    ids=["speculative", "slo", "request_trace", "int8", "queue_bound"])
def test_unported_features_raise(knob):
    """Speculative decoding, the SLO layer, request tracing and int8
    weights are ported, and asking for one arms it; a quantize mode
    other than int8 raises."""
    if "quantize" in knob:
        assert ContinuousBatchingEngine(_tiny(), device="cpu",
                                        **knob)._quantized
        with pytest.raises(NotImplementedError, match="not ported"):
            ContinuousBatchingEngine(_tiny(), device="cpu", quantize="int4")
        return
    if "speculative" in knob:
        assert ContinuousBatchingEngine(_tiny(), device="cpu", **knob)._spec
        return
    if "request_trace" in knob:
        assert ContinuousBatchingEngine(_tiny(), device="cpu",
                                        **knob)._rtrace
        return
    if "slo" in knob or "max_queue_tokens" in knob:
        eng = ContinuousBatchingEngine(_tiny(), device="cpu", **knob)
        assert eng._slo
        assert eng.max_queue_tokens == knob.get("max_queue_tokens")
        return
    raise AssertionError(f"no case for {knob}")


def test_int8_on_the_card_refuses_an_f32_model(monkeypatch):
    """The W8A16 kernel takes bf16 or f16 activations, so an int8 engine
    for an f32 model on the card raises NotImplementedError when it is
    built, not at its first tick. The refusal comes before anything is
    placed on the device, so a CUDA device name is enough to reach it."""
    from paddle_tpu_torch.inference import serving
    monkeypatch.setattr(serving, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match="bf16 or f16"):
        ContinuousBatchingEngine(_tiny(), quantize="int8")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    if where == "repo":
        cwd, script = REPO, os.path.join(REPO, "chip_smoke.py")
    else:
        cwd = str(tmp_path)
        script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _chip_smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


# device kernel names as torch.profiler reports them on the card
_NAMES = {
    "void (anonymous namespace)::wgmma_swiglu_kernel<false, false, true, "
    "(anonymous namespace)::FwdEpi<__nv_bfloat16> >(CUtensorMap_st, "
    "CUtensorMap_st, int, int, int, (anonymous namespace)::FwdEpi<__nv_bfl":
        ("forward", "wgmma"),
    "void (anonymous namespace)::wgmma_swiglu_kernel<false, false, true, "
    "(anonymous namespace)::DguEpi<__nv_bfloat16> >(CUtensorMap_st":
        ("recompute", "wgmma"),
    "void (anonymous namespace)::wgmma_swiglu_kernel<false, true, false, "
    "(anonymous namespace)::StoreEpi>(CUtensorMap_st, CUtensorMap_st, int, "
    "int, int, (anonymous namespace)::StoreEpi)": ("da", "wgmma"),
    "void (anonymous namespace)::wgmma_swiglu_kernel<true, false, false, "
    "(anonymous namespace)::StoreEpi>(CUtensorMap_st": ("dw", "wgmma"),
    "void (anonymous namespace)::mma_kernel<false, false, true, (anonymous "
    "namespace)::FwdEpi<__nv_bfloat16> >(__nv_bfloat16 const*":
        ("forward", "mma.sync"),
    "void (anonymous namespace)::mma_kernel<false, false, true, (anonymous "
    "namespace)::DguEpi<__nv_bfloat16> >(__nv_bfloat16 const*":
        ("recompute", "mma.sync"),
    "void (anonymous namespace)::mma_kernel<true, false, false, (anonymous "
    "namespace)::StoreEpi>(__nv_bfloat16 const*": ("dw", "mma.sync"),
    "void (anonymous namespace)::gemm_simt_kernel<true, false>(float "
    "const*": None,
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64": None,
}


@pytest.mark.parametrize("name", sorted(_NAMES))
def test_swiglu_route_of_reads_kernel_names(name):
    """chip_smoke's SwiGLU route check tells the wgmma core from the
    mma.sync kernel and names the product by the template arguments."""
    assert _chip_smoke().swiglu_route_of(name) == _NAMES[name]


@pytest.mark.parametrize("shape,want", [
    ((8192, 4096, 11008), dict(forward="wgmma", recompute="wgmma",
                               da="wgmma", dw="wgmma")),
    ((128, 4096, 11008), dict(forward="mma.sync", recompute="wgmma",
                              da="wgmma", dw="wgmma")),
    ((77, 100, 60), dict(forward="mma.sync", recompute="mma.sync",
                         da="wgmma", dw="mma.sync")),
    ((1000, 1024, 1000), dict(forward="wgmma", recompute="wgmma",
                              da="wgmma", dw="wgmma")),
    ((300, 1024, 1001), dict(forward="mma.sync", recompute="mma.sync",
                             da="mma.sync", dw="mma.sync"))],
    ids=["llama_7b", "serving_rows", "scalar_edges", "wgmma_tiles",
         "odd_m"])
def test_expected_swiglu_routes(shape, want):
    """The cores csrc/swiglu.cu's routing test gives each bf16 product:
    TMA needs every operand row to be whole 16-byte vectors, and the
    forward at up to 128 rows stays on the mma.sync kernel."""
    assert _chip_smoke().expected_swiglu_routes(*shape) == want


# flash device kernel names as torch.profiler reports them on the card
_FLASH_NAMES = {
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(CUtensorMap_st,"
    " CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, int, int, "
    "int, int, float)": ("forward", "wgmma"),
    "void (anonymous namespace)::flash_bwd_dkv_wgmma_kernel<64>("
    "CUtensorMap_st": ("dkv", "wgmma"),
    "void (anonymous namespace)::flash_bwd_dq_wgmma_kernel<128>("
    "CUtensorMap_st": ("dq", "wgmma"),
    "void (anonymous namespace)::flash_delta_kernel<__nv_bfloat16, 128>("
    "__nv_bfloat16 const*, __nv_bfloat16 const*, float*, int, int, int)":
        ("delta", "simt"),
    "void (anonymous namespace)::flash_fwd_mma_kernel<128, false, false>("
    "__nv_bfloat16 const*": ("forward", "mma.sync"),
    # the segment forward: bf16 on the wgmma core, f32 on its
    # 3xTF32 form
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<64, true>("
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int const*, int "
    "const*, __nv_bfloat16*, float*, int, int, int, int, int, float)":
        ("forward", "wgmma"),
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<128, false>("
    "CUtensorMap_st": ("forward", "wgmma"),
    "void (anonymous namespace)::flash_fwd_tf32_kernel<64, true>("
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int const*, int "
    "const*, float*, float*, int, int, int, int, int, float)":
        ("forward", "wgmma-tf32"),
    "void (anonymous namespace)::flash_fwd_tf32_kernel<128, false>("
    "CUtensorMap_st": ("forward", "wgmma-tf32"),
    "void (anonymous namespace)::flash_fwd_mma_kernel<64>(__nv_bfloat16 "
    "const*": ("forward", "mma.sync"),
    # the segment backward: bf16 on the wgmma core with ids (the bias
    # route's backward keeps the mma.sync kernels)
    "void (anonymous namespace)::flash_bwd_dkv_wgmma_kernel<64, true>("
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float "
    "const*, float const*, int const*, int const*, __nv_bfloat16*, "
    "__nv_bfloat16*, int, int, int, int, int, float)": ("dkv", "wgmma"),
    "void (anonymous namespace)::flash_bwd_dq_wgmma_kernel<128, true>("
    "CUtensorMap_st": ("dq", "wgmma"),
    "void (anonymous namespace)::flash_bwd_dkv_mma_kernel<128>("
    "__nv_bfloat16 const*": ("dkv", "mma.sync"),
    "void (anonymous namespace)::flash_bwd_dkv_mma_kernel<64, true, false>("
    "__nv_bfloat16 const*": ("dkv", "mma.sync"),
    "void (anonymous namespace)::flash_bwd_dq_mma_kernel<128, false, true>("
    "__nv_bfloat16 const*": ("dq", "mma.sync"),
    "void (anonymous namespace)::flash_fwd_simt_kernel<64, false>(float "
    "const*": ("forward", "simt"),
    "void (anonymous namespace)::flash_bwd_dq_simt_kernel<128, true>(float "
    "const*": ("dq", "simt"),
    # the f32 backward on the 3xTF32 core (one length, and the segment
    # route with ids); the bias route's f32 kernels stay SIMT
    "void (anonymous namespace)::flash_bwd_dkv_tf32_kernel<64, true>("
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float "
    "const*, float const*, int const*, int const*, float*, float*, int, "
    "int, int, int, int, float)": ("dkv", "wgmma-tf32"),
    "void (anonymous namespace)::flash_bwd_dkv_tf32_kernel<128, false>("
    "CUtensorMap_st": ("dkv", "wgmma-tf32"),
    "void (anonymous namespace)::flash_bwd_dq_tf32_kernel<64, false>("
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float "
    "const*, float const*, int const*, int const*, float*, int, int, int, "
    "int, int, float)": ("dq", "wgmma-tf32"),
    "void (anonymous namespace)::flash_bwd_dq_tf32_kernel<128, true>("
    "CUtensorMap_st": ("dq", "wgmma-tf32"),
    "void (anonymous namespace)::flash_fwd_simt_kernel<64>(float const*, "
    "float const*, float const*, (anonymous namespace)::BiasArgs, float*, "
    "float*, int, int, int, int, int, float)": ("forward", "simt"),
    "void (anonymous namespace)::flash_bwd_dkv_simt_kernel<128>(float "
    "const*": ("dkv", "simt"),
    "void (anonymous namespace)::flash_bwd_dq_simt_kernel<64>(float "
    "const*": ("dq", "simt"),
    # PyTorch's own flash kernels (SDPA) and the SwiGLU core are not ours
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 128, "
    "64, 4, false, false, cutlass::bfloat16_t": None,
    "void pytorch_flash::flash_bwd_dot_do_o_kernel<true, Flash_bwd_kernel_"
    "traits": None,
    "void (anonymous namespace)::wgmma_swiglu_kernel<false, true, false, "
    "(anonymous namespace)::StoreEpi>(CUtensorMap_st": None,
}


@pytest.mark.parametrize("name", sorted(_FLASH_NAMES))
def test_flash_route_of_reads_kernel_names(name):
    """chip_smoke's flash route check tells the wgmma core from the
    mma.sync and SIMT kernels, names the launch, and ignores PyTorch's
    own flash kernels."""
    assert _chip_smoke().flash_route_of(name) == _FLASH_NAMES[name]


_WGMMA = dict(forward="wgmma", dkv="wgmma", dq="wgmma", delta="simt")
_TF32 = dict(forward="wgmma-tf32", dkv="wgmma-tf32", dq="wgmma-tf32",
             delta="simt")


@pytest.mark.parametrize("shape,dtype,want", [
    ((4, 2048, 32, 32, 128, True), "bfloat16", _WGMMA),
    ((4, 2048, 16, 16, 128, True), "bfloat16", _WGMMA),
    ((2, 256, 8, 2, 128, True), "bfloat16", _WGMMA),
    ((2, 256, 4, 4, 64, False), "bfloat16", _WGMMA),
    ((1, 1000, 4, 4, 128, True), "bfloat16", _WGMMA),
    ((2, 1000, 4, 2, 64, False), "bfloat16", _WGMMA),
    ((4, 2048, 32, 32, 128, True), "float32", _TF32),
    ((16, 512, 12, 12, 64, False), "float32", _TF32),
    ((2, 1000, 4, 2, 64, False), "float32", _TF32)],
    ids=["llama_7b", "llama_1b", "gqa_causal", "d64_full", "ragged_causal",
         "ragged_gqa_d64", "f32", "ernie_f32", "ragged_gqa_d64_f32"])
def test_expected_flash_routes(shape, dtype, want):
    """Every bf16 call of flash_attention_fwd / flash_attention_bwd runs
    the wgmma core, every f32 call its 3xTF32 form (no SIMT kernel),
    whatever the shape (ragged S included)."""
    got = _chip_smoke().expected_flash_routes(*shape, getattr(torch, dtype))
    assert got == want


@pytest.mark.parametrize("shape", [(1, 128, 4, 4, 96, True),
                                   (1, 128, 6, 4, 64, False)],
                         ids=["d96", "heads_not_a_multiple"])
def test_expected_flash_routes_refuses_untaken_shapes(shape):
    with pytest.raises(ValueError, match="flash takes no"):
        _chip_smoke().expected_flash_routes(*shape, torch.bfloat16)


_SEG_BF16 = dict(forward="wgmma", dkv="wgmma", dq="wgmma", delta="simt")
_SEG_F32 = dict(forward="wgmma-tf32", dkv="wgmma-tf32", dq="wgmma-tf32",
                delta="simt")


@pytest.mark.parametrize("shape,dtype,want", [
    ((16, 512, 512, 12, 12, 64, False), "bfloat16", _SEG_BF16),
    ((16, 512, 512, 12, 12, 64, False), "float32", _SEG_F32),
    ((1, 8192, 8192, 32, 32, 128, True), "bfloat16", _SEG_BF16),
    ((2, 256, 256, 8, 2, 128, True), "float32", _SEG_F32),
    ((3, 200, 328, 4, 4, 64, False), "bfloat16", _SEG_BF16),
    ((1, 700, 700, 4, 1, 64, False), "float32", _SEG_F32)],
    ids=["bert", "bert_f32", "packed_7b", "gqa_causal_f32", "cross_len",
         "mqa_f32"])
def test_expected_seg_routes(shape, dtype, want):
    """The segment forward and backward run the wgmma core in bf16 and
    its 3xTF32 kernels in f32, never an mma.sync or SIMT kernel; the
    backward after the delta pre-pass."""
    got = _chip_smoke().expected_seg_routes(*shape, getattr(torch, dtype))
    assert got == want


@pytest.mark.parametrize("shape", [(1, 128, 128, 4, 4, 96, False),
                                   (1, 128, 128, 6, 4, 64, False),
                                   (1, 128, 256, 4, 4, 64, True)],
                         ids=["d96", "heads_not_a_multiple",
                              "causal_cross_length"])
def test_expected_seg_routes_refuses_untaken_shapes(shape):
    with pytest.raises(ValueError, match="segment route takes no"):
        _chip_smoke().expected_seg_routes(*shape, torch.bfloat16)


@pytest.mark.parametrize("dtype,core", [("bfloat16", "mma.sync"),
                                        ("float32", "simt")])
def test_expected_bias_routes(dtype, core):
    """The bias route keeps csrc/flash_attention.cu's kernels: mma.sync in
    bf16 and SIMT in f32, forward, dkv and dq (its D is plain PyTorch)."""
    got = _chip_smoke().expected_bias_routes(getattr(torch, dtype))
    assert got == dict(forward=core, dkv=core, dq=core)


def test_every_segment_case_has_a_route():
    """chip_smoke.py traces every `testing.ATTN_SEG_CASES` case in bf16
    (and "bert" in f32): each is a shape the segment route takes."""
    from paddle_tpu_torch import testing
    cs = _chip_smoke()
    for kw in testing.ATTN_SEG_CASES.values():
        S = kw["S"]
        shape = (kw["B"], S, kw.get("Sk", S), kw["hq"], kw["hk"], kw["d"],
                 kw["causal"])
        assert cs.expected_seg_routes(*shape, torch.bfloat16)["forward"] \
            == "wgmma"


@pytest.mark.parametrize("layer", ["Linear", "Embedding", "LayerNorm",
                                   "BatchNorm2D", "Transformer", "PReLU"])
def test_nn_layers_need_a_card_unless_cpu_is_asked(layer):
    """A layer with parameters makes them on `cuda` unless the caller
    names another device; with no card that raises, and device="cpu"
    builds. A layer without parameters needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from paddle_tpu_torch import nn as tnn
    args = {"Linear": (4, 4), "Embedding": (10, 4), "LayerNorm": (4,),
            "BatchNorm2D": (4,), "Transformer": (64, 2, 1, 1, 64),
            "PReLU": (4,)}[layer]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tnn, layer)(*args)
    built = getattr(tnn, layer)(*args, device="cpu")
    assert all(p.device.type == "cpu" for p in built.parameters())
    assert tnn.ReLU()(torch.ones(2)).tolist() == [1.0, 1.0]
