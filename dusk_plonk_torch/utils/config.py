"""Runtime configuration of the port.

Only the knobs that still apply on a GPU are kept from
dusk_plonk_tpu/utils/config.py, with its names and defaults; its tile
sizes, 14-bit switches, stacked twiddle limit, quotient chunking and mesh
settings are TPU or 16 GB-HBM rules, and its off-TPU `ntt_mxu_force` has
no counterpart (the route depends on the config alone; on CPU tensors
every kernel runs its plain version).  One process-global config, read
when a plan is built.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class TorchPlonkConfig:
    msm_window_bits: int | None = None  # Pippenger window width override
                                        # (None = size-adaptive, ops/msm.py)
    msm_chunk_len: int = 256            # sequential depth of the chunk scan
                                        # (kernel K11a's step count)
    ec_scan_em: bool = False            # chunk scan with element-major
                                        # output (kernel K12, ops/msm.py)
    ntt_mxu_min_k: int | None = None    # four-step int8 tensor-core NTT
                                        # (ops/mxu_ntt.py, kernel K13) for
                                        # domains 2^k with k >= this;
                                        # None = the K2 butterfly ladder


_config = TorchPlonkConfig()


def get_config() -> TorchPlonkConfig:
    return _config


def set_config(**overrides) -> TorchPlonkConfig:
    """Replace fields of the global config (affects plans built after the
    call).  Returns the new config."""
    global _config
    _config = replace(_config, **overrides)
    return _config
