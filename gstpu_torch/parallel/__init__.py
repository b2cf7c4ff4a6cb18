"""Multi-device training and rendering on ``torch.distributed``: the mesh
(``mesh.py``), process-group start-up (``multihost.py``), the collectives
with their gradients (``collectives.py``) and the sharded render and train
step (``sharded.py``)."""

from gstpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from gstpu_torch.parallel.sharded import (make_sharded_render,  # noqa: F401
                                          make_sharded_train_step)
