"""gstpu_torch: the PyTorch and CUDA port of gstpu's 3D Gaussian Splatting.

It imports ``torch`` and nothing of JAX or of the ``gstpu`` package.  The
port so far covers the forward render (preprocess, tile binning, forward
compositing) and the single-device training step (the differentiable
render with its hand-written backward, the losses, Adam, the model).  The
forward and backward compositing are hand-written CUDA kernels for the H100
(``csrc/rasterize_fwd.cu``, ``csrc/rasterize_bwd.cu``) with plain PyTorch
versions for CPU tensors.

Float32 semantics: TF32 is switched off for matmuls and cuDNN convolutions;
reduced-precision projection was found to stall training in the JAX package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gstpu_torch.config import GSConfig, RenderSettings  # noqa: E402
from gstpu_torch.render import render_gaussians  # noqa: E402

__all__ = ["GSConfig", "RenderSettings", "render_gaussians"]
