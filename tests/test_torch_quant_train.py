"""The port's training quantization (nemo_tpu_torch/ops/quant.py: quantize,
quant_matmul, TrainingQuantDense) and its MFU script
(nemo_tpu_torch/scripts/train_mfu.py) against the JAX package, on the CPU.

Tolerances: the casts (e4m3, e5m2, int8 codes and their scales) and the int8
products bitwise equal to JAX's; fp8 outputs and both gradients within 1e-6
of the tensor's max-abs in fp32 (the same quantised operands, summed in
another order), within one bf16 step (2^-8) of the max-abs in bf16. The
port's `make_cfg`/`make_cfg_1b` equal scripts/train_mfu.py's field by
field, and `run()` at a tiny size on the CPU returns the JAX script's keys.
The model-level fp8 checks are in tests/test_torch_quant_model.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import scripts.train_mfu as jax_mfu  # noqa: E402
from nemo_tpu.ops import quant as jax_quant  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables)
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm.gpt import check_supported  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402
from nemo_tpu_torch.ops import quant  # noqa: E402
from nemo_tpu_torch.scripts import train_mfu  # noqa: E402

MODES = ["fp8", "fp8_e4m3", "int8"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASTS = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "e5m2": (jnp.float8_e5m2, torch.float8_e5m2), "int8": (jnp.int8, torch.int8)}


def _close(got: torch.Tensor, want, dtype: str, what: str) -> None:
    want = np.asarray(want, np.float32)
    tol = (1e-6 if dtype == "float32" else 2.0 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=tol, err_msg=what)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x


@pytest.mark.parametrize("cast", sorted(CASTS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_is_bitwise_jax(cast, dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 96) * 3.0).astype(np.float32)
    x[0, 0] = 0.0
    jd, td = DTYPES[dtype]
    jq, js = jax_quant.quantize(jnp.asarray(x).astype(jd), CASTS[cast][0])
    q, s = quant.quantize(torch.from_numpy(x).to(td), CASTS[cast][1])
    assert q.dtype == CASTS[cast][1] and s.dtype == torch.float32
    np.testing.assert_array_equal(_bits(q.view(torch.uint8) if q.element_size() == 1 else q),
                                  _bits(jq))
    assert float(s) == float(js)


def test_int8_product_is_bitwise_jax():
    rng = np.random.RandomState(1)
    a = rng.randint(-127, 128, (48, 80)).astype(np.int8)
    b = rng.randint(-127, 128, (80, 32)).astype(np.int8)
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = quant.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_matmul_matches_jax(mode, dtype):
    """[B, T, K] @ [K, N] (w given as the transposed view a Linear weight
    gives), forward, dgrad and wgrad, in the output and input dtypes JAX
    gives them."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 24, 96).astype(np.float32)
    w = (rng.randn(96, 48) * 0.05).astype(np.float32)
    g = rng.randn(2, 24, 48).astype(np.float32)
    jd, td = DTYPES[dtype]
    y, vjp = jax.vjp(lambda a, b: jax_quant.quant_matmul(a, b, mode, jd),
                     jnp.asarray(x).astype(jd), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g).astype(jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    weight = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    yt = quant.quant_matmul(xt, weight.t(), mode, td)
    dxt, dwt = torch.autograd.grad(yt, (xt, weight), torch.from_numpy(g).to(td))
    assert (yt.dtype, dxt.dtype, dwt.dtype) == (td, td, torch.float32)
    _close(yt, y, dtype, "y")
    _close(dxt, dx, dtype, "dx")
    _close(dwt.t(), dw, "float32", "dw")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", ["q_proj", "o_proj"])
def test_training_quant_dense_matches_jax(mode, form):
    """JAX's QuantDense with features (H, dh) (q_proj) and with the
    contraction over (H, dh) (o_proj, axis=(-2, -1)), bf16 activations and
    an fp32 kernel, against the port's TrainingQuantDense from
    `dense_layer`: output, input gradient and kernel gradient."""
    H, dh, D = 2, 32, 64
    rng = np.random.RandomState(3)
    if form == "q_proj":
        contract, features, axis = (D,), (H, dh), -1
        x = rng.randn(2, 16, D).astype(np.float32)
    else:
        contract, features, axis = (H, dh), (D,), (-2, -1)
        x = rng.randn(2, 16, H, dh).astype(np.float32)
    jax_mod = jax_quant.QuantDense(features=features if len(features) > 1 else features[0],
                                   mode=mode, axis=axis, dtype=jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    params = jax_mod.init(jax.random.PRNGKey(0), xj)["params"]
    kernel = np.asarray(nn.meta.unbox(params)["kernel"])
    assert kernel.shape == contract + features
    y, vjp = jax.vjp(lambda p, a: jax_mod.apply({"params": p}, a), params, xj)
    g = rng.randn(*y.shape).astype(np.float32)
    dparams, dx = vjp(jnp.asarray(g).astype(jnp.bfloat16))

    layer = quant.dense_layer(mode, contract, features, torch.float32)
    assert isinstance(layer, quant.TrainingQuantDense) and layer.mode == mode
    tree = {"params": {"k": {"kernel": kernel}}}
    holder = torch.nn.Module()
    holder.k = layer
    load_jax_variables(holder, tree)
    xt = torch.from_numpy(x.reshape(2, 16, -1)).to(torch.bfloat16).requires_grad_()
    yt = layer(xt)
    dxt, dwt = torch.autograd.grad(yt, (xt, layer.weight),
                                   torch.from_numpy(g.reshape(yt.shape)).to(torch.bfloat16))
    _close(yt, np.asarray(y, np.float32).reshape(yt.shape), "bfloat16", "y")
    _close(dxt, np.asarray(dx, np.float32).reshape(dxt.shape), "bfloat16", "dx")
    got = export_jax_variables(holder, {"k.weight": dwt})["params"]["k"]["kernel"]
    _close(torch.from_numpy(got), np.asarray(nn.meta.unbox(dparams)["kernel"]), "float32", "dw")


def test_training_modes_are_supported_and_the_head_stays_full_precision():
    for mode in MODES:
        cfg = port_config.tiny_test(quantization=mode, share_embeddings_and_output_weights=False)
        check_supported(cfg)
        mod = GPTTrainModule(cfg, device="cpu")
        assert isinstance(mod.model.layers[0].attention.o_proj, quant.TrainingQuantDense)
        assert type(mod.model.lm_head) is quant.Dense
    with pytest.raises(ValueError, match="int8_ptq"):
        GPTTrainModule(port_config.tiny_test(quantization="int8_ptq"), device="cpu")
    with pytest.raises(NotImplementedError, match="quantization"):
        check_supported(port_config.tiny_test(quantization="fp4"))


def test_make_cfg_equals_the_jax_script():
    for port, ref in ((train_mfu.make_cfg(), jax_mfu.make_cfg()),
                      (train_mfu.make_cfg("fp8", seq_length=1024, heads=16),
                       jax_mfu.make_cfg("fp8", seq_length=1024, heads=16)),
                      (train_mfu.make_cfg_1b(), jax_mfu.make_cfg_1b())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_run_on_the_cpu_returns_the_jax_keys():
    results = {q: train_mfu.run(None if q == "bf16" else q, steps=3, B=1, S=128, chunk=1,
                                model="tiny", device="cpu") for q in ("bf16", "fp8")}
    keys = {"quant", "tokens_per_sec", "tflops_per_sec", "mfu_vs_bf16_peak", "steps", "batch",
            "seq", "losses"}
    assert set(results["bf16"]) == keys | {"device"}
    assert set(results["fp8"]) == keys | {"device", "mfu_vs_fp8_peak"}
    assert results["fp8"]["device"] == "cpu" and results["fp8"]["quant"] == "fp8"
    assert [s for s, _ in results["bf16"]["losses"]] == [1, 2]
    line = train_mfu.overlay(results)
    assert line["fp8_vs_bf16_loss_at_step"] == 2 and line["rel_diff"] < 0.05
    with pytest.raises(ValueError, match="bf16"):
        train_mfu.run("fp8", steps=2, B=1, S=128, model="llama32_1b", device="cpu")
