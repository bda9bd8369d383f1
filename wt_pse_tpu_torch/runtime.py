"""Device selection and the f32 parity mode shared by every entry point."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent — there is no quiet
    fallback to the CPU.

    Also sets the parity mode: TF32 off for matmuls and cuDNN convolutions, so
    f32 stays IEEE f32 on the card. This mirrors the JAX package's
    ``Precision.HIGHEST`` pin at every conv and matmul
    (``wt_pse_tpu/models/layers.py:139-147``, ``ops/whitening.py:65-69,103``).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
