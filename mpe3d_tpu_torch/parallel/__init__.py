"""Device meshes: data- and tensor-parallel training over
``torch.distributed``, and the local device lists of multi-device
inference."""

from mpe3d_tpu_torch.parallel.mesh import (Mesh, data_block,  # noqa: F401
                                           init_distributed, make_mesh,
                                           pad_to_multiple)
