"""The device mesh of the port: the counterpart of nemo_tpu/parallel/mesh.py
(`MeshConfig` 30, `make_mesh` 82) over `torch.distributed` process groups.

The JAX package lays one `jax.sharding.Mesh` over its devices with the axes
(pp, dp, fsdp, cp, ep, tp). The port builds a
`torch.distributed.device_mesh.DeviceMesh` over ("dp", "cp") from an
initialised default process group (one process a rank: NCCL on cards,
gloo on the CPU); every other axis above 1 raises NotImplementedError.

    torch.distributed.init_process_group("nccl", init_method="tcp://localhost:29500",
                                         world_size=2, rank=rank)
    mesh = make_mesh(MeshConfig(cp=2))
    module = GPTTrainModule(cfg, device=f"cuda:{rank}", mesh=mesh)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism sizes (a copy of mesh.py:30). Their product must equal
    the number of ranks; dp is inferred when left at -1."""

    dp: int = -1
    fsdp: int = 1
    cp: int = 1
    ep: int = 1
    tp: int = 1
    pp: int = 1
    dcn_dp: int = 1
    dcn_pp: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        dcn = self.dcn_dp * self.dcn_pp
        known = self.fsdp * self.cp * self.ep * self.tp * self.pp * dcn
        dp = self.dp
        if dp == -1:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fsdp*cp*ep*tp*pp*dcn={known}")
            dp = n_devices // known
        if dp * known != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.fsdp}x{self.cp}x{self.ep}x{self.tp}x{self.pp} "
                f"(dcn {self.dcn_dp}x{self.dcn_pp}) != {n_devices} devices")
        return dataclasses.replace(self, dp=dp)


AXIS_NAMES = ("dp", "cp")


def make_mesh(cfg: MeshConfig):
    """→ a DeviceMesh of shape (dp, cp) named ("dp", "cp") over the ranks of
    the initialised default process group, on "cuda" under NCCL and "cpu"
    otherwise. Raises NotImplementedError for any other axis above 1 (fsdp,
    ep, tp, pp, dcn_dp, dcn_pp)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group first")
    cfg = cfg.resolved(dist.get_world_size())
    for axis in ("fsdp", "ep", "tp", "pp", "dcn_dp", "dcn_pp"):
        if getattr(cfg, axis) > 1:
            raise NotImplementedError(f"MeshConfig.{axis}={getattr(cfg, axis)} is not "
                                      f"implemented by the PyTorch port")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (cfg.dp, cfg.cp), mesh_dim_names=AXIS_NAMES)
