"""The one traffic generator: a mix's data file (plonkbench/traffic/<name>.json)
and the seed give the requests of a run.

Keys of a mix:
  loop      "closed": one client sends each request when the last proof
            returns (the only loop the harness runs).
  inputs    "uniform_below_bound": each circuit input drawn uniformly below
            the bound its circuit module states (input_bounds).
  warmup    proofs made before the window, as set-up.

Every number is derived from the seed by SHA-512 of a label, so a seed
gives the same requests on any machine, and request i does not depend on
how many came before it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


def derive(seed: int, label: str, bits: int = 64) -> int:
    """A `bits`-bit number from the seed and a label (bits <= 512)."""
    h = hashlib.sha512(f"plonkbench/{seed}/{label}".encode()).digest()
    return int.from_bytes(h, "little") >> (512 - bits)


@dataclass(frozen=True)
class Request:
    index: int
    inputs: dict            # the circuit's inputs, by name
    blinder_seed: int       # ChaCha12Rng.seed_from_u64 seed of the blinders


class Stream:
    def __init__(self, mix: dict, bounds: dict, seed: int):
        if mix.get("loop") != "closed":
            raise ValueError(f"loop must be 'closed': {mix!r}")
        if mix.get("inputs") != "uniform_below_bound":
            raise ValueError(f"unknown inputs: {mix.get('inputs')!r}")
        self.mix, self.bounds, self.seed = mix, dict(bounds), seed
        self.warmup = int(mix.get("warmup", 1))

    def _request(self, kind: str, i: int) -> Request:
        inputs = {name: derive(self.seed, f"{kind}/{i}/input/{name}", 512)
                  % bound for name, bound in sorted(self.bounds.items())}
        return Request(i, inputs, derive(self.seed, f"{kind}/{i}/blinders"))

    def warm(self, i: int) -> Request:
        return self._request("warm", i)

    def request(self, i: int) -> Request:
        return self._request("request", i)
