"""lcvo_tpu_torch — the PyTorch/CUDA port of ``lcvo_tpu``.

The same Markovian monocular VO state machine (bootstrap, per-frame step, chunked
streaming, re-bootstrap recovery) on fixed-capacity masked track tables, written as
plain PyTorch tensor code, with the JAX package's one Pallas kernel (KLT block
extraction) written again by hand in CUDA for Hopper (``csrc/extract_blocks.cu``).

Device rule: entry points take ``device=`` and default to ``"cuda"``. The port runs on
the CPU only when the caller asks for it (the tests do); it never falls back silently.
A kernel wrapper given a CUDA tensor launches its kernel or raises; given a CPU tensor
it runs the kernel's plain PyTorch version.

The package imports neither JAX nor anything of ``lcvo_tpu``.
"""

__version__ = "0.1.0"

import os as _os

import torch as _torch

# Geometric vision needs full-f32 products: reduced-precision multiplies corrupt
# subpixel interpolation and 3D reprojection (measured on the JAX package, see
# BASELINE.md round 3). Mirrors lcvo_tpu/__init__.py: pin full fp32, turn TF32 off
# for matmuls and cuDNN. Opt out with LCVO_NO_MATMUL_PRECISION_OVERRIDE=1 (set before
# import); the VO pipeline is not validated under the opt-out.
if not _os.environ.get("LCVO_NO_MATMUL_PRECISION_OVERRIDE"):
    _torch.backends.cuda.matmul.allow_tf32 = False
    _torch.backends.cudnn.allow_tf32 = False
    _torch.set_float32_matmul_precision("highest")

from lcvo_tpu_torch.config import VOConfig, load_config  # noqa: E402,F401
