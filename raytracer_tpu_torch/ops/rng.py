"""Counter-based per-pixel RNG: TEA-16 seeding + Numerical-Recipes LCG.

The port of raytracer_tpu/ops/rng.py, bit-exact to it: per-pixel seed =
tea(pixel_index, frame_number), stream = LCG with a=1664525, c=1013904223,
output = (state & 0xFFFFFF) / 2^24 in [0, 1).

Torch's uint32 arithmetic is partial, so a uint32 value lives in an int64
tensor in [0, 2^32) and every add, multiply and left shift is masked back
to 32 bits. Right shifts of such non-negative values are already logical.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

# TEA round constants (shaders/random.glsl:29-35).
_TEA_DELTA = 0x9E3779B9
_TEA_K0 = 0xA341316C
_TEA_K1 = 0xC8013EA4
_TEA_K2 = 0xAD90777D
_TEA_K3 = 0x7E95761E

# Numerical Recipes LCG (shaders/random.glsl:41-47).
_LCG_A = 1664525
_LCG_C = 1013904223
_MASK_24 = 0x00FFFFFF
_INV_2_24 = 1.0 / float(0x01000000)  # exact in f32


def tea(val0, val1):
    """16-round TEA hash of two uint32s (held as int64) -> uint32 as int64
    (shaders/random.glsl:23-37)."""
    dev = next((v.device for v in (val0, val1) if torch.is_tensor(v)), None)
    v0, v1 = torch.broadcast_tensors(
        torch.as_tensor(val0, dtype=torch.int64, device=dev),
        torch.as_tensor(val1, dtype=torch.int64, device=dev))
    v0 = v0 & _M32
    v1 = v1 & _M32
    s0 = 0
    for _ in range(16):
        s0 = (s0 + _TEA_DELTA) & _M32
        v0 = (v0 + ((((v1 << 4) + _TEA_K0) & _M32) ^ ((v1 + s0) & _M32)
                    ^ ((v1 >> 5) + _TEA_K1))) & _M32
        v1 = (v1 + ((((v0 << 4) + _TEA_K2) & _M32) ^ ((v0 + s0) & _M32)
                    ^ ((v0 >> 5) + _TEA_K3))) & _M32
    return v0


def lcg_step(state):
    """One LCG step: the new state, which is also the raw sample."""
    return (state * _LCG_A + _LCG_C) & _M32


def rnd(state):
    """Draw a float in [0, 1) and advance: (sample f32, new_state)
    (shaders/random.glsl:50-53)."""
    new_state = lcg_step(state)
    sample = (new_state & _MASK_24).to(torch.float32) * _INV_2_24
    return sample, new_state


def rnd_masked(state, mask):
    """Draw a sample but advance the state only where `mask` is True, so
    each lane's stream follows the reference's data-dependent serial
    consumption order."""
    sample, new_state = rnd(state)
    return sample, torch.where(mask, new_state, state)


def seed_pixels(pixel_index, frame_number):
    """Per-pixel seeds for a frame: tea(y*W+x, frame) (simple.rgen:71).
    `frame_number` is a scalar or a per-pixel tensor."""
    return tea(pixel_index, frame_number)
