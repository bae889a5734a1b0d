"""The parallel tiers over ``torch.distributed`` (``sunet_tf_tpu/parallel``):
the (data, spatial) mesh (``mesh.py``), its collectives (``comm.py``), the
spatial tier's exchanges and stage runner (``spatial.py``) and a launcher
of local ranks (``launch.py``)."""

from sunet_tf_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_rows,
    init_distributed,
    make_mesh,
    shard_batch,
)
