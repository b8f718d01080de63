"""The FM's initial parameters, made on the device from the seed.

``V`` is drawn as ``init_scale * N(0, 1)`` in row chunks of
:data:`CHUNK_ROWS` rows, each chunk from a ``torch.Generator`` of its own
seeded from ``(seed, chunk)``, so that any chunk can be drawn again alone:
the benchmark draws them all once to build the learner's table, then again
one at a time to measure how far the table moved, and the reference draws
the rows it touches. The padding sink (the last row) is zero; ``w`` and
``w0`` start at zero."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

CHUNK_ROWS = 1 << 23


def table_rows(config: dict) -> int:
    """The table's rows: the columns and the padding sink."""
    return config["num_col"] + 1


def _chunk_seed(seed: int, chunk: int) -> int:
    a, b = np.random.SeedSequence([seed, 7, chunk]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def v_chunks(config: dict, seed: int, device, dtype=torch.float32
             ) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(first row, [rows, factors] block)`` for every chunk of ``V``."""
    rows, factors = table_rows(config), config["num_factors"]
    for i, start in enumerate(range(0, rows, CHUNK_ROWS)):
        n = min(CHUNK_ROWS, rows - start)
        gen = torch.Generator(device=device).manual_seed(_chunk_seed(seed, i))
        block = torch.randn((n, factors), generator=gen, device=device)
        block.mul_(config["init_scale"])
        if start + n == rows:
            block[-1].zero_()
        yield start, block.to(dtype)


def full(config: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w0, w, V)`` whole, float32 on ``device``."""
    rows = table_rows(config)
    v = torch.empty((rows, config["num_factors"]), device=device)
    for start, block in v_chunks(config, seed, device):
        v[start:start + len(block)] = block
        del block
    return torch.zeros((), device=device), torch.zeros(rows, device=device), v


def rows_of(config: dict, seed: int, ids: torch.Tensor, dtype=torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w0, w[ids], V[ids])`` for sorted unique row ids on their device."""
    v = torch.empty((len(ids), config["num_factors"]), dtype=dtype, device=ids.device)
    for start, block in v_chunks(config, seed, ids.device, dtype):
        inside = (ids >= start) & (ids < start + len(block))
        v[inside] = block[ids[inside] - start]
        del block
    return (torch.zeros((), dtype=dtype, device=ids.device),
            torch.zeros(len(ids), dtype=dtype, device=ids.device), v)
