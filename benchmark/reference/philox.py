"""Philox4x32-10 counter-based bits and the seed derivations, in plain torch.

Frozen copy of epitpu_torch/rng.py at commit 0f2ab30 (``_mulhilo``,
``philox4x32``, ``seed_key``, ``splitmix64``, ``derive_seed``,
``uniform_from_bits``, ``box_muller``, and ``lane_draws`` without the lane
map).  The counter layout is the tau-leap kernel's:

    key     = (seed & 0xFFFFFFFF, seed >> 32)
    counter = (lane, call offset, substep, draw slot)

Every 32-bit word is held in an int64 tensor.
"""
from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 of four broadcastable int64 counter words and a key of
    two ints; four int64 tensors of u32 words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*(torch.as_tensor(c, dtype=torch.int64)
                                               for c in counter))
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def seed_key(seed: int):
    seed = int(seed) & _MASK64
    return seed & _MASK32, seed >> 32


def splitmix64(seed: int) -> int:
    z = (int(seed) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(seed: int, *path: int) -> int:
    """The 64-bit seed of sub-stream ``path`` of ``seed`` (a splitmix64
    chain)."""
    s = splitmix64(seed)
    for p in path:
        s = splitmix64(s ^ (int(p) & _MASK64))
    return s


def uniform_from_bits(bits):
    """u32 words -> float32 uniforms in [0, 1) (top 23 bits as mantissa)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def box_muller(u1, u2):
    u1 = torch.clamp(u1, min=1e-12)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * math.pi) * u2)


def lane_draws(seed: int, offset: int, steps, n_lanes: int, n_slots: int, device):
    """(uniform, normal) float32 ``[len(steps), n_lanes, n_slots]`` of
    counter (lane, ``offset``, step, slot): word 0 the uniform, words 1 and
    2 the Box-Muller normal."""
    steps = torch.as_tensor(list(steps), dtype=torch.int64, device=device)
    lanes = torch.arange(n_lanes, dtype=torch.int64, device=device)
    slots = torch.arange(n_slots, dtype=torch.int64, device=device)
    w0, w1, w2, _ = philox4x32(
        (lanes[None, :, None], torch.tensor(int(offset) & _MASK32, device=device),
         steps[:, None, None], slots[None, None, :]),
        seed_key(seed),
    )
    return uniform_from_bits(w0), box_muller(uniform_from_bits(w1), uniform_from_bits(w2))
