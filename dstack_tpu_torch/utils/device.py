"""Device resolution for the port's entry points.

Everything the port serves runs on a CUDA card by default.  A missing card
is an error, never a quiet slide onto the CPU: the CPU is used only when
the caller names it (``device="cpu"``, ``--device cpu``), which is what the
CPU test suite does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA (raises when no card is visible); an explicit
    device is returned as given, after the same check for CUDA ones."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) "
            "to run on the CPU explicitly")
    return dev
