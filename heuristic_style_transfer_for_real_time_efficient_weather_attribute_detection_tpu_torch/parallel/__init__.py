"""Training and multi-device execution of the port.

``parallel.train`` is the train step (data and task sharding over a mesh
included); ``parallel.mesh`` lays the ``torch.distributed`` world out as a
device mesh, one process per card; ``parallel.multihost`` joins a process
to the world and feeds it its own rows of a global batch.
"""

from . import mesh  # noqa: F401
from .mesh import make_mesh, pad_to_multiple  # noqa: F401
