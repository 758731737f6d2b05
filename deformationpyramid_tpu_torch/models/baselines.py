"""Baseline deformation models: NSFP and Nerfies.

Counterpart of ``deformationpyramid_tpu/models/baselines.py``:

* ``Neural_Prior`` (NSFP, reference ``model/nets.py:256-292``): a plain
  9-layer MLP that regresses scene flow;
* ``Nerfies_Deformation`` (``model/nets.py:187-253``): windowed multi-band
  positional encoding with a coarse-to-fine schedule, an SE(3)-field warp
  and per-point Jacobians for the elastic regulariser.

Both keep torch's default ``nn.Linear`` init (U(-1/sqrt(fan_in), ...)):
neither reference class calls the xavier reset. Parameters are the JAX
package's trees (NSFP a list of ``{"w": [in, out], "b": [out]}`` layers,
Nerfies a dict of such layers), so ``params_from_numpy`` carries weights
across.
"""
from __future__ import annotations

import dataclasses

import torch

from ..geometry import rotations as rot
from .pyramid import tree_map

Tensor = torch.Tensor


def _torch_linear_init(gen: torch.Generator, fan_in: int, fan_out: int
                       ) -> dict[str, Tensor]:
    bound = 1.0 / fan_in ** 0.5
    return {
        "w": (torch.rand((fan_in, fan_out), generator=gen) * 2.0 - 1.0)
        * bound,
        "b": (torch.rand((fan_out,), generator=gen) * 2.0 - 1.0) * bound,
    }


# ---------------------------------------------------------------------------
# NSFP (Neural Scene Flow Prior)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NSFPConfig:
    width: int = 128
    n_layers: int = 9  # 1 input + 7 hidden + 1 output (nets.py:262-273)
    act: str = "relu"


def nsfp_dims(cfg: NSFPConfig) -> list[int]:
    return [3] + [cfg.width] * (cfg.n_layers - 1) + [3]


def init_nsfp_params(gen: torch.Generator, cfg: NSFPConfig = NSFPConfig(),
                     device: torch.device | str | None = None) -> list[dict]:
    """Layer list drawn from a CPU generator, so one seed gives the same
    weights on every device."""
    dims = nsfp_dims(cfg)
    return tree_map(lambda t: t.to(device),
                    [_torch_linear_init(gen, dims[i], dims[i + 1])
                     for i in range(cfg.n_layers)])


def nsfp_flow(params: list[dict], x: Tensor,
              cfg: NSFPConfig = NSFPConfig()) -> Tensor:
    """x [N, 3] -> flow [N, 3]; activation on all but the last layer."""
    act = torch.relu if cfg.act == "relu" else torch.sigmoid
    h = x
    for i, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = act(h)
    return h


# ---------------------------------------------------------------------------
# Nerfies deformation field
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NerfiesConfig:
    depth: int = 7
    width: int = 128
    m_bands: int = 6
    k0: int = -3
    max_iter: int = 5000

    @property
    def n_coarse(self) -> float:
        # sliding-window schedule constant N = 0.6 * max_iter (nets.py:203)
        return 0.6 * self.max_iter

    @property
    def dim_in(self) -> int:
        return self.m_bands * 6 + 3


def init_nerfies_params(gen: torch.Generator,
                        cfg: NerfiesConfig = NerfiesConfig(),
                        device: torch.device | str | None = None) -> dict:
    inp = _torch_linear_init(gen, cfg.dim_in, cfg.width)
    hidden = [_torch_linear_init(gen, cfg.width, cfg.width)
              for _ in range(cfg.depth - 1)]
    return tree_map(lambda t: t.to(device), {
        "input": inp,
        "hidden": hidden,
        "w": _torch_linear_init(gen, cfg.width, 3),
        "v": _torch_linear_init(gen, cfg.width, 3),
    })


def nerfies_posenc(pos: Tensor, it: Tensor | int, cfg: NerfiesConfig
                   ) -> Tensor:
    """Windowed multi-band encoding with schedule alpha = m*iter/N.

    Matches ``nets.py:218-240``: bands at 2**(j+k0) * pi with pi = 3.14 (the
    reference's literal), window w_a = (1 - cos(clamp(a-j, 0, 1) pi)) / 2,
    output [pos, sin/cos bands]. ``it`` may be a 0-d tensor on the device.
    """
    pi = 3.14
    f32 = dict(dtype=torch.float32, device=pos.device)
    j = torch.arange(cfg.m_bands, **f32)
    it = torch.as_tensor(it, **f32)
    a = cfg.m_bands * it / cfg.n_coarse
    w_a = (1.0 - torch.cos(torch.clamp(a - j, 0.0, 1.0) * pi)) / 2.0  # [m]
    mul = 2.0 ** (j + cfg.k0) * pi                                      # [m]
    ang = pos[..., :, None] * mul                                       # [N, 3, m]
    enc = torch.cat([
        torch.sin(ang[..., 0, :]) * w_a, torch.cos(ang[..., 0, :]) * w_a,
        torch.sin(ang[..., 1, :]) * w_a, torch.cos(ang[..., 1, :]) * w_a,
        torch.sin(ang[..., 2, :]) * w_a, torch.cos(ang[..., 2, :]) * w_a,
    ], dim=-1)
    return torch.cat([pos, enc], dim=-1)


def nerfies_warp(params: dict, x: Tensor, it: Tensor | int,
                 cfg: NerfiesConfig = NerfiesConfig()) -> Tensor:
    """SE(3)-field warp (``nets.py:242-253``): per-point screw motion."""
    fea = nerfies_posenc(x, it, cfg)
    fea = torch.relu(fea @ params["input"]["w"] + params["input"]["b"])
    for p in params["hidden"]:
        fea = torch.relu(fea @ p["w"] + p["b"])
    w = fea @ params["w"]["w"] + params["w"]["b"]
    v = fea @ params["v"]["w"] + params["v"]["b"]
    theta = torch.sqrt(torch.clamp_min(
        torch.sum(w * w, dim=-1, keepdim=True), 1e-12))
    w = w / theta
    v = v / theta
    R, t = rot.exp_se3(w, v, theta)
    return torch.einsum("...ij,...j->...i", R, x) + t[..., 0]


def nerfies_jacobian(params: dict, x: Tensor, it: Tensor | int,
                     cfg: NerfiesConfig = NerfiesConfig()) -> Tensor:
    """Per-point warp Jacobian [N, 3, 3].

    The reference differentiates the batch sum (``nets.py:213-215``) which,
    because each output point depends only on its own input, equals the
    per-point Jacobian; here forward mode, vmapped over the points.
    """

    def warp_one(xi):
        return nerfies_warp(params, xi, it, cfg)

    return torch.func.vmap(torch.func.jacfwd(warp_one))(x)
