"""Parameters carried across from the JAX package.

The JAX package keeps field elements as uint32 numpy/JAX arrays of 16-bit
limbs, (..., L, N); the port keeps the same values in int32 tensors.
`limbs_from_numpy` moves one into the other; TorchEngine accepts the JAX
package's packed selector, sigma and SRS arrays through it, so both
engines can prove from one key and one SRS.  `params_from_jax` carries a
JAX PlonkParams, packed SRS included, into the port's.
"""

from __future__ import annotations

import numpy as np
import torch


def limbs_from_numpy(arr, device) -> torch.Tensor:
    """uint32 (or int32) limb planes, values < 2^16 -> int32 tensor on
    `device`."""
    a = np.asarray(arr)
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limb values must be 16-bit")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(
        device)


def as_limbs(x, device) -> torch.Tensor:
    """The JAX package's packed numpy limbs, or a tensor, on `device`."""
    if isinstance(x, np.ndarray):
        return limbs_from_numpy(x, device)
    return x.to(device)


def params_from_jax(params):
    """The JAX package's PlonkParams -> the port's.  Its packed SRS (three
    (24, N) uint32 Montgomery planes of the affine powers, `packed`, as
    from_packed_npz loads it) is carried as it is, and device key
    compilation reads it through limbs_from_numpy; host powers, G2 points
    and the generator come along."""
    from .kzg.srs import PlonkParams
    packed = None if params.packed is None else \
        tuple(np.asarray(c) for c in params.packed)
    return PlonkParams(params.powers, params.h, params.beta_h, packed=packed,
                       g=params._g)
