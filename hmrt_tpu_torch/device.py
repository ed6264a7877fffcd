"""Where the port's tensors live when the caller does not say.

Every public function that takes `device` runs on the card unless asked
for another device: `None` means CUDA, and a machine without CUDA raises
instead of quietly rendering on the host. Pass `device="cpu"` to run the
plain torch versions on the CPU (as the tests do).
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device.
    Raises RuntimeError when None is given and CUDA is unavailable."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("hmrt_tpu_torch runs on a CUDA device by default and "
                           "none is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
