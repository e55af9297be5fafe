"""The process-group ring (nemo_tpu_torch/ops/ring_attention.py:
ProcessGroupRing, parallel/mesh.py:make_mesh, GPTTrainModule over a mesh)
in two gloo processes on the CPU, against the same work with every rank in
one process (`LocalRing`), which tests/test_torch_ring.py holds against
the JAX package.

- `ring_flash_attention` at cp 2, at test_torch_ring.py's shapes (B=1, H=4
  over G=2, S=512, dh 64, fp32): each process its rank's shard; the outputs
  and the gradients of q, k and v within 1e-6. `make_mesh` builds the
  ("dp", "cp") mesh and refuses the axes that are not ported.
- One `train_step` of test_torch_ring.py's tiny model at cp 2 across the
  two processes, each given the whole global batch: the loss and grad norm
  within 1e-6 relative of the one-process cp 2 step, and every rank's
  parameters equal after the step (AdamW's first step moves a leaf by
  about lr · sign(g), so a gradient near 0 summed in another order may
  move it the other way: the one-process step's parameters are not held
  to the bit).

The two processes (torch.multiprocessing, "spawn") are started once for
both tests and given a deadline of their own, so that a hung group fails
the tests fast.
Only torch and the port are imported here: the processes import this file.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nemo_tpu_torch.models.llm.config import tiny_test  # noqa: E402
from nemo_tpu_torch.models.llm.train import GPTTrainModule  # noqa: E402
from nemo_tpu_torch.ops import ring_attention as ring_ops  # noqa: E402

S, CP = 512, 2
DEADLINE_S = 120


def _cfg(**kw):
    return tiny_test(seq_length=S, num_layers=2, hidden_size=64, num_attention_heads=4,
                     num_query_groups=2, attention_backend="flash", **kw)


def _attention_inputs():
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(1, h, S, 64).astype(np.float32))
                   for h in (4, 2, 2, 4))
    return q, k, v, do, torch.from_numpy(ring_ops.zigzag_order(S, CP).astype(np.int32))


def _batch():
    rng = np.random.RandomState(6)
    return {"tokens": rng.randint(0, 128, (2, S)), "labels": rng.randint(0, 128, (2, S)),
            "loss_mask": (rng.rand(2, S) > 0.2).astype(np.float32)}


def _ring_attention(q, k, v, do, pos, ring):
    """Zig-zag shards of the held ranks → (o, dq, dk, dv) of those ranks,
    each [R, B, heads, Tl, dh]."""
    R, Tl = ring.held, S // CP
    leaves = [ring_ops.zigzag_shard(t, CP, 2).view(1, t.shape[1], CP, Tl, 64)
              .permute(2, 0, 1, 3, 4)[ring.rank:ring.rank + R].contiguous().requires_grad_()
              for t in (q, k, v)]
    dos = ring_ops.zigzag_shard(do, CP, 2).view(1, 4, CP, Tl, 64).permute(2, 0, 1, 3, 4)
    qpos = pos.view(CP, Tl)[ring.rank:ring.rank + R]
    o = ring_ops.ring_flash_attention(*leaves, qpos, ring, scale=0.125)
    grads = torch.autograd.grad(o, leaves, dos[ring.rank:ring.rank + R])
    return [o.detach(), *grads]


def _worker(rank, store, out_dir):
    import torch.distributed as dist

    from nemo_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=CP, rank=rank)
    try:
        mesh = make_mesh(MeshConfig(cp=CP))
        for axis in ("tp", "fsdp"):
            try:
                make_mesh(MeshConfig(dp=1, cp=1, **{axis: CP}))
            except NotImplementedError as e:
                assert f"MeshConfig.{axis}" in str(e)
            else:
                raise AssertionError(f"make_mesh took {axis} > 1")
        ring = ring_ops.ProcessGroupRing(mesh["cp"].get_group())
        assert (ring.size, ring.rank, ring.held) == (CP, rank, 1)
        attention = _ring_attention(*_attention_inputs(), ring)
        mod = GPTTrainModule(_cfg(), device="cpu", seed=0, mesh=mesh)
        assert mod.cfg.cp_size == CP and isinstance(mod.model.ring, ring_ops.ProcessGroupRing)
        metrics = mod.train_step(_batch())
        train = [metrics["loss"], metrics["grad_norm"]] + [p.detach() for p in mod.params]
        torch.save({"attention": attention, "train": train}, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run `_worker` in CP gloo processes, once for both tests; fail if they
    have not all ended within DEADLINE_S. → each rank's saved results."""
    import torch.multiprocessing as mp

    tmp_path = tmp_path_factory.mktemp("gloo")
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "store"), str(tmp_path)),
                             nprocs=CP, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"gloo processes still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(CP)]


def test_process_group_ring_matches_local_ring(ranks):
    want = _ring_attention(*_attention_inputs(), ring_ops.LocalRing(CP))
    for r, got in enumerate(x["attention"] for x in ranks):
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g[0], w[r], atol=1e-6, rtol=1e-6, msg=f"rank {r} {name}")


def test_cp2_train_step_over_processes_matches_one_process(ranks):
    mod = GPTTrainModule(_cfg(cp_size=CP), device="cpu", seed=0)
    assert isinstance(mod.model.ring, ring_ops.LocalRing)
    metrics = mod.train_step(_batch())
    for r, (loss, norm, *params) in enumerate(x["train"] for x in ranks):
        for key, got in (("loss", loss), ("grad_norm", norm)):
            want = float(metrics[key])
            assert abs(float(got) - want) <= 1e-6 * abs(want), (r, key, float(got), want)
        for (name, _), p, p0 in zip(mod.model.named_parameters(), params,
                                    ranks[0]["train"][2:]):
            assert torch.equal(p, p0), (r, name)  # every rank took the same step
