"""kimera_vio_tpu_torch — the PyTorch / CUDA port of kimera_vio_tpu.

Same algorithms, shapes and masks as the JAX package (which stays the
reference), run eagerly by PyTorch on an NVIDIA H100. The one Pallas TPU
kernel of the reference (pyramidal Lucas-Kanade,
kimera_vio_tpu/ops/pallas/lk_kernel.py) is a hand-written CUDA kernel here
(csrc/lk_kernel.cu, bound in ops/lk_kernel.py), and so is the per-frame
half of the reference's default tracker (`klt_track_cached`, which XLA
runs on the TPU): `lk_cached_kernel` in the same file.

Rules kept by every module:

  * imports: torch, numpy, scipy and the standard library only;
  * device: entry points take `device=` (default "cuda") and raise when
    CUDA is absent, unless the caller asked for "cpu" — nothing falls back
    to the CPU quietly;
  * precision: float32 throughout with TF32 off for cuBLAS and cuDNN, the
    counterpart of the reference's "highest" matmul precision
    (kimera_vio_tpu/__init__.py:17).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; a CUDA request on a machine without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kimera_vio_tpu_torch: CUDA was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
