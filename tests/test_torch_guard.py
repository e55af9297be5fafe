"""Guards of the PyTorch port: it imports no JAX and nothing of `nemo_tpu`,
its entry points do not drop quietly to the CPU, and chip_smoke.py fails
where it cannot run."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from nemo_tpu_torch.models.asr.configs import conformer_ctc  # noqa: E402
from nemo_tpu_torch.models.asr.ctc_models import EncDecCTCModel  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import nemo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nemo_tpu_torch.__path__, "nemo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nemo_tpu"))
assert not bad, bad
print(" ".join(names))
"""

# the serving and TTS modules, which the walk must reach (they import no JAX either)
SERVING = ("nemo_tpu_torch.ops.quant", "nemo_tpu_torch.models.llm.generate",
           "nemo_tpu_torch.serve.openai_server", "nemo_tpu_torch.llm.api",
           "nemo_tpu_torch.models.tts", "nemo_tpu_torch.models.tts.fastpitch_model",
           "nemo_tpu_torch.models.tts.hifigan_model", "nemo_tpu_torch.models.tts.modules.fastpitch",
           "nemo_tpu_torch.models.tts.modules.hifigan", "nemo_tpu_torch.serve.audio_server",
           "nemo_tpu_torch.agents.voice_agent", "nemo_tpu_torch.data.text_tokenizers")
# the FastConformer-TDT slice's modules, which the walk must reach as well
TDT = ("nemo_tpu_torch.ops.tdt", "nemo_tpu_torch.models.asr.rnnt_models",
       "nemo_tpu_torch.models.asr.modules.rnnt", "nemo_tpu_torch.models.asr.modules.conformer",
       "nemo_tpu_torch.models.asr.synthetic", "nemo_tpu_torch.models.asr.configs")


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names = out.stdout.split()
    assert len(names) >= 20  # every module of the package was imported
    assert set(SERVING) <= set(names), sorted(set(SERVING) - set(names))
    assert set(TDT) <= set(names), sorted(set(TDT) - set(names))


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("flag,key", [("--time-forward", "k5_ms"), ("--time-backward", "k6_ms")])
def test_chip_smoke_forward_timing_fails_without_a_card(flag, key):
    """`chip_smoke.py --time-forward` and `--time-backward` (the A/B timings
    of the bf16 flash forward and backward) need a card too: each exits
    non-zero and prints no timing."""
    out = subprocess.run([sys.executable, "chip_smoke.py", flag, "--tree", "."],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert key not in out.stdout


def test_wgmma_tile_product_runs_on_the_card_or_raises():
    """The unit check of csrc/hopper.cuh takes bf16 tiles on the card only:
    CPU tensors, other dtypes and other shapes raise before any build."""
    from nemo_tpu_torch.csrc.loader import wgmma_tile_product

    a, b = torch.zeros(64, 64, dtype=torch.bfloat16), torch.zeros(128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on the card"):
        wgmma_tile_product(a, b, False, "tma")
    with pytest.raises(ValueError, match="bf16"):
        wgmma_tile_product(a.float(), b.float(), False, "registers")
    with pytest.raises(ValueError, match="N 64 or 128"):
        wgmma_tile_product(a, b[:96], False, "tma")
    with pytest.raises(ValueError, match="N 64 or 128"):
        wgmma_tile_product(a, b, True, "tma")  # MN-major b is [64, N]


def test_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncDecCTCModel(conformer_ctc("small"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncDecCTCModel(conformer_ctc("small"), device="cuda")


def test_serving_without_device_needs_cuda(monkeypatch):
    """The engines and the server run on the card unless `device="cpu"` is
    given: without a card they raise, before they touch the weights."""
    from nemo_tpu_torch.models.llm.config import tiny_test
    from nemo_tpu_torch.models.llm.generate import ContinuousBatchingEngine, GenerationEngine
    from nemo_tpu_torch.serve.openai_server import LLMServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: GenerationEngine(tiny_test(), {}),
                 lambda: ContinuousBatchingEngine(tiny_test(), {}),
                 lambda: LLMServer(tiny_test(), {}, tokenizer=None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_tdt_model_without_device_needs_cuda(monkeypatch):
    """The FastConformer-TDT model runs on the card unless `device="cpu"`
    is given: without a card it raises."""
    from nemo_tpu_torch.core.config import ConfigDict
    from nemo_tpu_torch.models.asr.configs import fastconformer_ctc
    from nemo_tpu_torch.models.asr.rnnt_models import EncDecRNNTModel

    cfg = fastconformer_ctc("small")
    cfg.encoder.n_layers = 1
    cfg.decoder = ConfigDict(pred_hidden=16, vocabulary=cfg.labels)
    cfg.joint = ConfigDict(joint_hidden=16)
    cfg.model_defaults = ConfigDict(tdt_durations=(0, 1, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncDecRNNTModel(cfg)


def test_tts_without_device_needs_cuda(monkeypatch):
    """FastPitch and HiFi-GAN, the AudioServer's TTS pair, run on the card
    unless `device="cpu"` is given: without a card they raise."""
    from nemo_tpu_torch.models.tts import FastPitchModel, HifiGanModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (FastPitchModel, HifiGanModel, lambda: FastPitchModel(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_fit_synthetic_asr_refusals_name_the_roadmap_item():
    """`fit_synthetic_asr` refuses a CTC model and the full transducer step,
    and both refusals send the reader to ROADMAP.md A5 (what is left of
    RNNT and TDT). Stand-in models: a plain object is no transducer, one with
    a blank id and a symbol cap is."""
    from types import SimpleNamespace

    from nemo_tpu_torch.models.asr.synthetic import fit_synthetic_asr

    with pytest.raises(NotImplementedError, match="CTC model.*ROADMAP.md A5"):
        fit_synthetic_asr(SimpleNamespace())
    with pytest.raises(NotImplementedError, match="make_train_step.*ROADMAP.md A5"):
        fit_synthetic_asr(SimpleNamespace(blank_id=0, max_symbols=10), head_only=False)
