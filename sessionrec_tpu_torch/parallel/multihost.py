"""Multi-process runtime of the mesh.

Counterpart of ``sessionrec_tpu/parallel/multihost.py``.  Every rank of a
port's mesh is a process, so the process group always exists where a
mesh does:

* ``initialize`` starts it (``torch.distributed.init_process_group``) from
  a coordinator address, the number of processes and this process's id;
  ``cli train`` calls it for the workers it spawns on one host, and for
  each process of a launch with ``--coordinator``.
* Each process of a ``--coordinator`` launch builds only its rows of every
  global batch (``local_batch_slice``): the global example stream stays
  the time-ordered stream, global batch k is examples ``[kB, (k+1)B)``,
  and the rank of data position d builds rows ``[d B/dp, (d+1) B/dp)``.
* ``place_chunk`` moves a chunk of the rank's batches to its device: the
  rank's rows are its part of the global batch, and nothing assembles it.
* Logging, metrics and checkpoint files are the primary's (rank 0);
  checkpoints are gathered collectively (``utils/checkpoint.py``).
"""

from __future__ import annotations

import torch.distributed as dist

from sessionrec_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl"):
    """Join the process group at ``coordinator`` (``host:port``) as
    process ``process_id`` of ``num_processes``; False (and nothing done)
    when all three are None."""
    if coordinator is None and num_processes is None and process_id is None:
        return False
    if None in (coordinator, num_processes, process_id):
        raise ValueError("a multi-process launch needs --coordinator, "
                         "--num-processes and --process-id together")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    log.info("process group up: process %d of %d over %s",
             dist.get_rank(), dist.get_world_size(), backend)
    return True


def is_primary() -> bool:
    """True on rank 0, and where there is no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(mesh, global_batch: int) -> tuple[int, int]:
    """Rows ``[start, stop)`` of each global batch that this rank's data
    position owns: block ``d`` of ``dp`` contiguous blocks."""
    if global_batch % mesh.dp:
        raise ValueError(f"batch size {global_batch} not divisible by "
                         f"data-parallel degree {mesh.dp}")
    per = global_batch // mesh.dp
    return mesh.d * per, (mesh.d + 1) * per


def place_chunk(mesh, chunk):
    """The rank's batches of ``chunk`` on its device."""
    return [b.to(mesh.device) for b in chunk]
