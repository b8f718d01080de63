"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the CPU: ``device=None``
means ``cuda``, and a CUDA device on a host without one raises instead of
falling back. The CPU runs only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from dmlc_tpu_torch.utils.check import DMLCError


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DMLCError(
                "CUDA is not available on this host; the port runs on the "
                "card unless the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
