"""Scale-out of the index and the search (counterpart of
``kmerseek_tpu/parallel/``).

* ``multihost`` — a ``torch.distributed`` process group (Gloo: every
  payload is a host numpy array moved as bytes), the round-robin
  data-parallel build and the full-replica exchange;
* ``sharded`` — the hash-range-sharded index across processes: build,
  per-shard save/load, and manysearch/multisearch whose per-shard tuples
  merge to the single-process result bit for bit;
* ``dist`` — one process, several devices: a ``Mesh`` of explicit
  ``torch.device`` shards for the data-parallel sketch step, the
  target-sharded pair statistics and the position-sharded dense and
  sparse inverted search.
"""
