"""Carry arrays across to the port: NumPy dicts -> torch tensors.

- ``params_from_numpy`` takes the parameter dict of the JAX package's
  ``GaussianModel.param_dict()`` or of ``utils.ply.load_ply`` (NumPy arrays
  keyed ``positions``, ``scales``, ``rotations``, ``opacities``, ``shs``).
- ``prep_from_numpy`` and ``pairs_from_numpy`` rebuild ``PreprocessOut`` and
  ``Pairs`` from stored ``prep_*`` / ``pairs_*`` arrays, such as those of
  ``tests/golden/pallas_gate.npz``.
- ``model_from_numpy`` and ``adam_from_numpy`` rebuild a ``GaussianModel``
  and an ``AdamState`` from the fields of the JAX package's (as NumPy
  arrays); ``model_to_numpy`` and ``adam_to_numpy`` go back, so both
  packages can start from one model and one set of moments.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gstpu_torch.models.gaussians import GaussianModel
from gstpu_torch.ops.binning import Pairs
from gstpu_torch.ops.preprocess import PreprocessOut
from gstpu_torch.optim import AdamState

PARAM_KEYS = ("positions", "scales", "rotations", "opacities", "shs")


def pad_shs(shs: torch.Tensor) -> torch.Tensor:
    """(N, k, 3) or (N, 3k) SH coefficients -> (N, 16, 3), zero-padded to
    the fixed 16-coefficient layout of degree 3."""
    n = shs.shape[0]
    shs = shs.reshape(n, -1, 3)
    return torch.cat([shs, shs.new_zeros((n, 16 - shs.shape[1], 3))], 1)


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device) -> dict[str, torch.Tensor]:
    """float32 tensors on ``device``; ``shs`` reshaped and zero-padded to
    (N, 16, 3)."""
    out = {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
           for k in PARAM_KEYS}
    out["shs"] = pad_shs(out["shs"])
    out["opacities"] = out["opacities"].reshape(-1)
    return out


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def prep_from_numpy(arrays: Mapping[str, np.ndarray], device,
                    prefix: str = "prep_") -> PreprocessOut:
    return PreprocessOut(**{k: _tensor(arrays[prefix + k], device)
                            for k in PreprocessOut._fields})


def pairs_from_numpy(arrays: Mapping[str, np.ndarray], device,
                     prefix: str = "pairs_") -> Pairs:
    return Pairs(**{k: _tensor(arrays[prefix + k], device)
                    for k in Pairs._fields})


def model_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> GaussianModel:
    """``GaussianModel`` from the parameter arrays and ``alive``; ``n_alive``
    is taken from ``arrays`` when present, else counted from ``alive``."""
    params = params_from_numpy(arrays, device)
    alive = torch.tensor(np.asarray(arrays["alive"], bool), device=device)
    n_alive = arrays["n_alive"] if "n_alive" in arrays else alive.sum()
    return GaussianModel(**params, alive=alive,
                         n_alive=torch.tensor(int(n_alive), dtype=torch.int32,
                                              device=device))


def model_to_numpy(model: GaussianModel) -> dict[str, np.ndarray]:
    return {**{k: v.detach().cpu().numpy()
               for k, v in model.param_dict().items()},
            "alive": model.alive.cpu().numpy(),
            "n_alive": np.int32(int(model.n_alive))}


def adam_from_numpy(m: Mapping[str, np.ndarray], v: Mapping[str, np.ndarray],
                    device) -> AdamState:
    """``AdamState`` from first and second moments keyed like the
    parameters (shapes as ``params_from_numpy`` makes them)."""
    return AdamState(m=params_from_numpy(m, device),
                     v=params_from_numpy(v, device))


def adam_to_numpy(state: AdamState):
    """(m, v) as dicts of NumPy arrays."""
    return ({k: x.cpu().numpy() for k, x in state.m.items()},
            {k: x.cpu().numpy() for k, x in state.v.items()})
