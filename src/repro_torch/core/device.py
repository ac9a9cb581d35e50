"""Where an entry point runs: on ``cuda`` unless the caller asks for
another device. Without a card, asking for nothing (or for ``cuda``)
raises — an entry point never carries on quietly on the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' (--device cpu) to run its plain versions on the "
            "CPU")
    return dev
