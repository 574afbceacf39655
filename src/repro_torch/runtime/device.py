"""Device selection for the port's entry points.

Entry points run on the card by default. Without a CUDA device they
raise instead of carrying on elsewhere; the CPU runs only when a caller
asks for it (`device="cpu"`), as the tests do. The meta device
(`device="meta"`: shapes and dtypes, nothing computed) is the dry run's
(`launch.dryrun`), also only on request.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         "'meta'")
    return dev
