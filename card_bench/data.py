"""Seeded inputs, made on the device in bulk: a copy of the program's
`seeded.py` generator `seeded_images`, drawn from a `torch.Generator`
instead of numpy so that a pool of hundreds of 640 px images takes
milliseconds. Same distribution: images of 8x8 pixel blocks of uniform
random colour.
"""
from __future__ import annotations

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator of its own for each use of one seed."""
    return torch.Generator(device=device).manual_seed((seed * 8 + stream) % (2 ** 63))


def seeded_images(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 images of 8x8-pixel random blocks."""
    blocks = torch.randint(0, 256, (n, size // 8, size // 8, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    return blocks.repeat_interleave(8, 1).repeat_interleave(8, 2).contiguous()
