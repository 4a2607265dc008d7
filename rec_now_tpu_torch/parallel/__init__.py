"""Multi-process training: the process mesh and its start-up."""
from rec_now_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, Mesh, make_mesh)
from rec_now_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost)
