"""Runtime configuration of the port.

Only the knobs that still apply on a GPU are kept from
dusk_plonk_tpu/utils/config.py; its tile sizes, 14-bit switches, stacked
twiddle limit, quotient chunking and mesh settings are TPU or 16 GB-HBM
rules.  One process-global config, read when a plan is built.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class TorchPlonkConfig:
    msm_window_bits: int | None = None  # Pippenger window width override
                                        # (None = size-adaptive, ops/msm.py)
    msm_chunk_len: int = 256            # sequential depth of the chunk scan
                                        # (kernel K11a's step count)


_config = TorchPlonkConfig()


def get_config() -> TorchPlonkConfig:
    return _config


def set_config(**overrides) -> TorchPlonkConfig:
    """Replace fields of the global config (affects plans built after the
    call).  Returns the new config."""
    global _config
    _config = replace(_config, **overrides)
    return _config
