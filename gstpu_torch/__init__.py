"""gstpu_torch: the PyTorch and CUDA port of gstpu's 3D Gaussian Splatting.

It imports ``torch`` and nothing of JAX or of the ``gstpu`` package.  The
port covers the forward render (preprocess, tile binning, forward
compositing), training (the differentiable render with its hand-written
backward, the losses, Adam, the model, densification, the ``Trainer`` and
``python -m gstpu_torch.train``, the NeRF and COLMAP loaders), multi-device
training and rendering on ``torch.distributed`` (``parallel/``), the CLIs
(``python -m gstpu_torch.render``, ``.eval_model``, ``.render_turntable``)
and the measurement path (``bench``, ``bench_suite``, ``sol_model``, the
kernel gate ``ops/kernel_check``).  The forward
and backward compositing are hand-written CUDA kernels for the H100
(``csrc/rasterize_fwd.cu``, ``csrc/rasterize_bwd.cu``), and so is the
speed-of-light model's compositing (``csrc/sol_compositing.cu``), each with
a plain PyTorch version for CPU tensors.

Float32 semantics: TF32 is switched off for matmuls and cuDNN convolutions;
reduced-precision projection was found to stall training in the JAX package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gstpu_torch.config import GSConfig, RenderSettings  # noqa: E402

__all__ = ["GSConfig", "RenderSettings", "render_gaussians"]


def __getattr__(name):
    # imported on first use, so that ``python -m gstpu_torch.render`` does
    # not find its own module imported already by the package
    if name == "render_gaussians":
        from gstpu_torch.render import render_gaussians
        return render_gaussians
    raise AttributeError(f"module 'gstpu_torch' has no attribute {name!r}")
