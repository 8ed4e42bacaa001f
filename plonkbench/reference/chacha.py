"""ChaCha12-based StdRng, mirroring Rust's `rand::rngs::StdRng` (rand 0.8 =
rand_chacha's ChaCha12Rng).

Every reference test seeds `StdRng::seed_from_u64(8349)` (e.g.
tests/boolean.rs:21); SRS generation, witness blinding and Fr::random all
draw from this stream, so bit-exact proofs require reproducing it faithfully:

* seed_from_u64 expands the u64 via SplitMix64 into a 32-byte seed
  (rand::SeedableRng::seed_from_u64).
* ChaCha12Rng refills a 256-byte buffer at a time (4 ChaCha blocks with
  consecutive 64-bit block counters), exposing it as 64 little-endian u32s.
* next_u64 = lo_u32 | hi_u32 << 32; fill_bytes consumes whole u32s (a
  trailing partial word discards its unused bytes).
"""

from __future__ import annotations

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def _rotl32(v, c):
    return ((v << c) | (v >> (32 - c))) & _MASK32


def _quarter(state, a, b, c, d):
    state[a] = (state[a] + state[b]) & _MASK32
    state[d] = _rotl32(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK32
    state[b] = _rotl32(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & _MASK32
    state[d] = _rotl32(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK32
    state[b] = _rotl32(state[b] ^ state[c], 7)


def chacha_block(key_words, counter: int, nonce_words, rounds: int):
    """One 64-byte ChaCha block -> list of 16 u32 words.

    Uses the rand_chacha layout: 64-bit block counter in words 12..13,
    64-bit stream id in words 14..15."""
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
    state += list(key_words)
    state += [counter & _MASK32, (counter >> 32) & _MASK32]
    state += list(nonce_words)
    working = state[:]
    for _ in range(rounds // 2):
        _quarter(working, 0, 4, 8, 12)
        _quarter(working, 1, 5, 9, 13)
        _quarter(working, 2, 6, 10, 14)
        _quarter(working, 3, 7, 11, 15)
        _quarter(working, 0, 5, 10, 15)
        _quarter(working, 1, 6, 11, 12)
        _quarter(working, 2, 7, 8, 13)
        _quarter(working, 3, 4, 9, 14)
    return [(w + s) & _MASK32 for w, s in zip(working, state)]


def splitmix64_seed(seed_u64: int) -> bytes:
    """rand::SeedableRng::seed_from_u64's SplitMix64 expansion to 32 bytes."""
    out = bytearray()
    state = seed_u64 & _MASK64
    for _ in range(4):
        state = (state + 0x9E3779B97F4A7C15) & _MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z = z ^ (z >> 31)
        out += z.to_bytes(8, "little")
    return bytes(out)


class ChaCha12Rng:
    """rand_chacha::ChaCha12Rng (BlockRng with 4-block refills)."""

    ROUNDS = 12

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                    for i in range(8)]
        self.stream = (0, 0)
        self.block_counter = 0          # counts 64-byte blocks
        self.buffer: list[int] = []     # u32 words
        self.index = 64                 # consumed position in buffer

    @classmethod
    def seed_from_u64(cls, v: int) -> "ChaCha12Rng":
        return cls(splitmix64_seed(v))

    def _refill(self):
        words = []
        for i in range(4):
            words += chacha_block(self.key, self.block_counter + i,
                                  self.stream, self.ROUNDS)
        self.block_counter += 4
        self.buffer = words
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= 64:
            self._refill()
        v = self.buffer[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        """Fill n bytes, consuming whole u32 words (rand's
        fill_via_u32_chunks semantics: the final partial word's leftover
        bytes are discarded)."""
        out = bytearray()
        while len(out) < n:
            if self.index >= 64:
                self._refill()
            # consume as many words as available/needed
            remaining = n - len(out)
            words_needed = (remaining + 3) // 4
            take = min(words_needed, 64 - self.index)
            for i in range(take):
                out += self.buffer[self.index + i].to_bytes(4, "little")
            self.index += take
        return bytes(out[:n])


def fr_random(rng: ChaCha12Rng) -> int:
    """bls-12-381's Fr::random: 64 wide bytes reduced mod r (the standard
    zkcrypto construction; draw order matters for bit-exactness, see
    SURVEY.md §7 risk #1)."""
    from .host import fr_from_bytes_wide
    return fr_from_bytes_wide(rng.fill_bytes(64))

