"""gstpu_torch: the PyTorch and CUDA port of gstpu's 3D Gaussian Splatting.

It imports ``torch`` and nothing of JAX or of the ``gstpu`` package.  The
port so far covers the forward render (preprocess, tile binning, forward
compositing), single-device training (the differentiable render with its
hand-written backward, the losses, Adam, the model, densification, the
``Trainer`` and ``python -m gstpu_torch.train``, the NeRF and COLMAP
loaders) and the measurement path (``bench``, ``bench_suite``,
``sol_model``, the kernel gate ``ops/kernel_check``).  The forward
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
from gstpu_torch.render import render_gaussians  # noqa: E402

__all__ = ["GSConfig", "RenderSettings", "render_gaussians"]
