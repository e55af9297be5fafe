"""The port's packed SFT path (nemo_tpu_torch/data/, core/lr_schedulers.py,
core/trainer.py, llm/api.py, llm/recipes.py) against the JAX package.

- `pack_batch` and `FineTuningDataModule` (packed and unpacked) give the JAX
  module's arrays exactly on one jsonl and tokenizer.
- `get_scheduler("CosineAnnealing", ...)` equals JAX's at steps 0 ..
  max_steps + 1 within 1e-7 relative at the tiny recipe's schedules; at
  llama32_1b's 1000-step SFT schedule within 2.5e-7, because XLA's float32
  cosine and a correctly rounded one differ by 1 ulp at ~1 % of arguments,
  and 1 + cos, near 0 late in the schedule, magnifies it.
- The whole slice: `finetune_recipe("tiny_test", peft_scheme="none", ...)
  .run(params, data)` in both packages on one packed jsonl, from the same
  parameters (tiny_test at S=128, fp32; the port on its flash backend, the
  plain K8-K10 on the CPU, JAX on its einsum backend as
  tests/test_torch_llm_packed.py explains), three steps: the losses and
  grad norms within 1e-5 relative and the learning rates within 1e-7.
- `load_jax_variables` takes a tree of tensors (as `finetune`'s `params`
  may be) and fills the same parameters as from the numpy tree, for a GPT
  (stacked layers, DenseGeneral kernels) and a Conformer (conv kernels).
- Guards: LoRA schemes, `log_dir`, `ckpt_io`, `resume` and `val_every > 0`
  raise NotImplementedError; a data module of another global batch raises.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from nemo_tpu.core.lr_schedulers import get_scheduler as jax_get_scheduler  # noqa: E402
from nemo_tpu.core.trainer import Trainer as JaxTrainer  # noqa: E402
from nemo_tpu.data.fine_tuning import FineTuningDataModule as JaxFineTuningDataModule  # noqa: E402
from nemo_tpu.data.packed_sequence import pack_batch as jax_pack_batch  # noqa: E402
from nemo_tpu.llm.recipes import finetune_recipe as jax_finetune_recipe  # noqa: E402
from nemo_tpu.models.llm import config as jax_config  # noqa: E402
from nemo_tpu.models.llm.train import GPTTrainModule as JaxGPTTrainModule  # noqa: E402
from nemo_tpu_torch.core.callbacks import Callback  # noqa: E402
from nemo_tpu_torch.core.lr_schedulers import get_scheduler  # noqa: E402
from nemo_tpu_torch.core.trainer import Trainer  # noqa: E402
from nemo_tpu_torch.data.fine_tuning import FineTuningDataModule  # noqa: E402
from nemo_tpu_torch.data.packed_sequence import pack_batch  # noqa: E402
from nemo_tpu_torch.interop.jax_params import (  # noqa: E402
    export_jax_variables, load_jax_variables, model_variables)
from nemo_tpu_torch.llm.api import finetune  # noqa: E402
from nemo_tpu_torch.llm.recipes import finetune_recipe  # noqa: E402
from nemo_tpu_torch.models.asr.configs import conformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel  # noqa: E402
from nemo_tpu_torch.models.llm import config as port_config  # noqa: E402
from nemo_tpu_torch.models.llm.gpt import build_model  # noqa: E402


class ByteTok:
    """One token per byte of lowercase text, and an eos (ids below 128)."""
    eos_id = 1

    def text_to_ids(self, text):
        return [2 + (b % 120) for b in text.encode()]


@pytest.fixture
def sft_jsonl(tmp_path):
    """120 {"input", "output"} examples of random lowercase words: inputs of
    8-60 bytes, outputs of 3-16."""
    rng = np.random.RandomState(0)

    def words(n):
        text = ""
        while len(text) < n:
            text += "".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 8))) + " "
        return text[:n].strip() or "a"

    path = tmp_path / "sft.jsonl"
    with open(path, "w") as f:
        for _ in range(120):
            f.write(json.dumps({"input": words(rng.randint(8, 61)),
                                "output": words(rng.randint(3, 17))}) + "\n")
    return str(path)


def test_pack_batch_matches_jax():
    rng = np.random.RandomState(1)
    lengths = rng.randint(1, 90, 40)
    seqs = [rng.randint(0, 128, n).astype(np.int32) for n in lengths]
    labels = [rng.randint(0, 128, n).astype(np.int32) for n in lengths]
    masks = [(rng.rand(n) > 0.5).astype(np.float32) for n in lengths]
    got = pack_batch(seqs, labels, masks, 96)
    want = jax_pack_batch(seqs, labels, masks, 96)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("packed", [True, False])
def test_data_module_matches_jax(sft_jsonl, packed):
    kw = dict(seq_length=128, global_batch_size=4, packed=packed, seed=3)
    got = FineTuningDataModule(sft_jsonl, ByteTok(), **kw).train_batches(1)
    want = JaxFineTuningDataModule(sft_jsonl, ByteTok(), **kw).train_batches(1)
    for _ in range(4):  # from step 1, across an epoch's end when packed
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for key in w:
            assert isinstance(g[key], torch.Tensor) and g[key].device.type == "cpu"
            assert np.array_equal(g[key].numpy(), np.asarray(w[key])), key
            assert g[key].numpy().dtype == np.asarray(w[key]).dtype, key


@pytest.mark.parametrize("kw,tol", [
    (dict(max_steps=3, lr=5e-6, warmup_steps=1, min_lr=0.0), 1e-7),
    (dict(max_steps=10, lr=5e-6, warmup_steps=50, min_lr=0.0), 1e-7),
    (dict(max_steps=10, lr=1e-3, warmup_ratio=0.25, min_lr=1e-5), 1e-7),
    (dict(max_steps=1000, lr=5e-6, warmup_steps=50, min_lr=0.0), 2.5e-7)])
def test_cosine_annealing_matches_jax(kw, tol):
    got, want = get_scheduler("CosineAnnealing", **kw), jax_get_scheduler("CosineAnnealing", **kw)
    for step in range(kw["max_steps"] + 2):
        w = float(want(step))
        assert isinstance(got(step), float)
        assert abs(got(step) - w) <= tol * abs(w), step


class Record(Callback):
    def __init__(self):
        self.steps = []

    def on_step_end(self, trainer, step, metrics):
        self.steps.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})


def test_finetune_recipe_run_matches_jax(sft_jsonl):
    """Three packed SFT steps of tiny_test at S=128 through both packages'
    recipe, finetune and Trainer, from the same parameters."""
    gbs = jax.device_count()  # the JAX side's mesh takes the batch over every device
    common = dict(peft_scheme="none", global_batch_size=gbs, max_steps=3, warmup_steps=1)
    jax_fr = jax_finetune_recipe("tiny_test", model=jax_config.tiny_test(seq_length=128),
                                 **common)
    fr = finetune_recipe("tiny_test", model=port_config.tiny_test(
        seq_length=128, attention_backend="flash"), **common)
    assert (fr.lr, fr.warmup_steps, fr.max_steps, fr.packed) == (5e-6, 1, 3, True)
    params = jax.device_get(JaxGPTTrainModule(jax_fr.model, mesh_cfg=jax_fr.mesh)
                            .init_state(seed=0).params)

    dm_kw = dict(seq_length=128, global_batch_size=gbs, packed=True)
    want = Record()
    jax_fr.run(params, JaxFineTuningDataModule(sft_jsonl, ByteTok(), **dm_kw),
               trainer=JaxTrainer(max_steps=3, callbacks=[want]))
    got, lrs = Record(), []

    class LR(Callback):
        def on_step_end(self, trainer, step, metrics):
            lrs.append(metrics["lr"])

    module, metrics = fr.run(params, FineTuningDataModule(sft_jsonl, ByteTok(), **dm_kw),
                             trainer=Trainer(max_steps=3, callbacks=[got, LR()]), device="cpu")
    assert module.step == 3 and module.device.type == "cpu" and metrics["lr"] == lrs[-1]
    assert len(got.steps) == len(want.steps) == 3
    for step, (g, w) in enumerate(zip(got.steps, want.steps)):
        for key in ("loss", "grad_norm"):
            assert abs(g[key] - w[key]) <= 1e-5 * abs(w[key]), (step, key, g[key], w[key])
    sched = jax_fr.lr_schedule()
    for step, lr in enumerate(lrs):
        assert abs(lr - float(sched(step))) <= 1e-7 * float(sched(step)), step


def test_what_is_not_ported_raises(sft_jsonl):
    for scheme in ("lora", "dora", "canonical_lora"):
        with pytest.raises(NotImplementedError, match="peft_scheme"):
            finetune_recipe("tiny_test", peft_scheme=scheme)
    with pytest.raises(ValueError, match="unknown peft_scheme"):
        finetune_recipe("tiny_test", peft_scheme="qlora")
    cfg = port_config.tiny_test(seq_length=64)
    dm = FineTuningDataModule(sft_jsonl, ByteTok(), seq_length=64, global_batch_size=2,
                              packed=True)
    for kw in (dict(log_dir="/nowhere"), dict(peft=object()), dict(mesh=object()),
               dict(optimizer=object())):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            finetune(cfg, None, dm, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="checkpointing"):
        Trainer(max_steps=1, ckpt_io=object())
    with pytest.raises(NotImplementedError, match="resume"):
        Trainer(max_steps=1, resume=object())
    with pytest.raises(NotImplementedError, match="val_every"):
        Trainer(max_steps=1, val_every=5)
    fr = finetune_recipe("tiny_test", peft_scheme="none", global_batch_size=4)
    with pytest.raises(ValueError, match="global_batch_size"):
        fr.run(None, dm, device="cpu")


def _tiny_model(kind, seed):
    if kind == "gpt":
        return build_model(port_config.tiny_test(seq_length=64), torch.device("cpu"), seed)
    cfg = conformer_ctc("large")
    cfg.encoder.update(n_layers=2, d_model=64, n_heads=4, feat_in=40)
    cfg.preprocessor.features = 40
    cfg.decoder.feat_in = 64
    return EncDecCTCModel(cfg, device="cpu", seed=seed)


@pytest.mark.parametrize("kind", ["gpt", "conformer"])
def test_load_jax_variables_takes_tensor_trees(kind):
    """A JAX-layout tree of tensors loads the same parameters as the numpy
    tree it equals: exactly, in every leaf."""
    src = _tiny_model(kind, seed=1)
    as_numpy, as_tensors = (export_jax_variables(src, as_tensors=t) for t in (False, True))
    leaves = lambda tree: [x for v in tree.values() for x in (  # noqa: E731
        leaves(v) if isinstance(v, dict) else [v])]
    assert all(isinstance(x, np.ndarray) for x in leaves(as_numpy))
    assert all(isinstance(x, torch.Tensor) for x in leaves(as_tensors))
    want = model_variables(src)
    for tree in (as_numpy, as_tensors):
        got = model_variables(load_jax_variables(_tiny_model(kind, seed=2), tree))
        assert got.keys() == want.keys()
        for name, value in want.items():
            assert torch.equal(got[name], value), name
