"""Multi-GPU scaling: one process per GPU, meshes of ranks, sharded render, collective extrema.

The JAX package scales over a device mesh driven by one process; the port
runs one ``torch.distributed`` rank per GPU (``torchrun --nproc-per-node
N``), each bound to its own card (:func:`.mesh.init_distributed`).  The
flagship batch splits the archive's orbits across ranks
(``fast/batch_directory.py``), each rank renders on its card, and the
folder-wide extrema reduction is an ``all_reduce`` over the mesh
(:func:`.extrema.sharded_extrema_stats`, optionally also sharding the time
axis).  Progress and resume state stay host-side JSON, one file per rank.
"""

from configurable_spectrograms_torch.parallel.extrema import sharded_extrema_stats
from configurable_spectrograms_torch.parallel.mesh import make_mesh
from configurable_spectrograms_torch.parallel.sharding import sharded_batch_render

__all__ = ["make_mesh", "sharded_extrema_stats", "sharded_batch_render"]
