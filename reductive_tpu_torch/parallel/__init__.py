"""Scale-out over several cards: meshes, sharded training, and distributed
encode.

Counterpart of ``reductive_tpu.parallel``.  One process a card joins a
``torch.distributed`` process group (:func:`initialize_distributed`: NCCL
between cards, gloo on the CPU), :func:`make_mesh` names the ranks' axes,
and every entry is called the same way on every rank:

* **data parallelism**: the instance matrix sharded by rows over the
  ``data`` axis; the centroid statistics (sums and counts) all-reduced over
  the axis's group once a Lloyd's iteration;
* **subquantizer (model) parallelism**: the ``m`` independent
  subquantizers sharded over the ``model`` axis
  (:func:`sharded_pq_train_step`); nothing but the loss crosses it.
"""

from .launch import initialize_distributed
from .mesh import make_mesh
from .sharded import (
    encode_sharded,
    sharded_kmeans,
    sharded_pq_train_step,
    stream_encode_sharded,
    train_opq_chunked_sharded,
    train_pq_chunked_sharded,
    train_pq_sharded,
    train_pq_streamed_sharded,
)

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "sharded_kmeans",
    "sharded_pq_train_step",
    "train_pq_sharded",
    "train_pq_chunked_sharded",
    "train_opq_chunked_sharded",
    "train_pq_streamed_sharded",
    "encode_sharded",
    "stream_encode_sharded",
]
