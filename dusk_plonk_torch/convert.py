"""Parameters carried across from the JAX package.

The JAX package keeps field elements as uint32 numpy/JAX arrays of 16-bit
limbs, (..., L, N); the port keeps the same values in int32 tensors.
`limbs_from_numpy` moves one into the other; TorchEngine accepts the JAX
package's packed selector, sigma and SRS arrays through it, so both
engines can prove from one key and one SRS.
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
