"""Process groups and the data-parallel index build (counterpart of
``kmerseek_tpu/parallel/multihost.py``).

Each process reads its own share of the FASTA, sketches it on its
device, and the per-process signature shards are exchanged so that
every process holds the identical global index (full-replica mode;
``parallel.sharded`` keeps only a hash range per process).

Record ownership is **round-robin by record ordinal** everywhere
(``host_owns_record``): a FASTA stream has no cheap record count, and
round-robin balances length-skewed proteomes for free.

The group is ``torch.distributed`` with the **Gloo** backend, on GPU
machines too: every payload that crosses processes is a host numpy
array, moved as a byte view (torch has no full ``uint64``, and a hash
must never pass through a signed or a float type), and Gloo lets
several ranks share one card, which NCCL refuses. Start a group by hand
with ``torchrun --nproc_per_node 2 script.py`` or with ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set for each process; with
neither, every function here runs as the only process and communicates
nothing.

The pack and merge steps are pure functions, tested by simulating
several processes' payloads; ``tests/test_torch_multihost_real.py``
forms a real 2-process group.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

# seconds a collective (or the rendezvous) may wait for the other ranks
# before the group fails: a rank that died must not leave the rest
# hanging for torch's default half hour
DEFAULT_GROUP_TIMEOUT_S = 300.0


def _dist():
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("this build of torch has no torch.distributed")
    return dist


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> Tuple[int, int]:
    """``torch.distributed.init_process_group("gloo", …)`` wrapper; a
    no-op on a single process. Returns ``(rank, world_size)``.

    A group that already exists is reported as it is. Otherwise one is
    formed when ``init_method`` (``tcp://host:port`` with ``world_size``
    and ``rank``) is given or the ``env://`` variables ``MASTER_ADDR``,
    ``RANK`` and ``WORLD_SIZE`` are set; with neither this returns
    ``(0, 1)``. ``KMERSEEK_DIST_TIMEOUT`` (seconds, default 300) bounds
    the rendezvous and every later collective."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    from_env = all(os.environ.get(v) for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if not init_method and not from_env:
        return 0, 1
    timeout_s = float(os.environ.get("KMERSEEK_DIST_TIMEOUT", DEFAULT_GROUP_TIMEOUT_S))
    dist.init_process_group(
        "gloo",
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.get_rank(), dist.get_world_size()


def rank_device(device=None, rank: int = 0) -> torch.device:
    """The device a rank sketches and searches on. A named device is
    taken as it is (``resolve_device``: CUDA without a GPU raises). With
    none named and several cards visible, the rank takes
    ``cuda:{LOCAL_RANK}`` where the launcher set it, else
    ``cuda:{rank % device_count}``; two ranks may share one card."""
    if device is None and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        local = os.environ.get("LOCAL_RANK")
        n = torch.cuda.device_count()
        return torch.device("cuda", int(local) % n if local is not None else rank % n)
    return resolve_device(device)


def host_owns_record(ordinal: int, process_index: int, process_count: int) -> bool:
    """Round-robin record ownership — the single sharding rule of every
    multi-process ingest path."""
    return ordinal % process_count == process_index


def iter_host_shard_batches(
    fasta: str,
    process_index: int,
    process_count: int,
    batch_size: int = 1000,
):
    """Stream only this process's records, each with its global
    ordinal: yields batches of (ordinal, FastaRecord) pairs."""
    from ..core.fasta import iter_fasta

    batch = []
    for i, rec in enumerate(iter_fasta(fasta)):
        if not host_owns_record(i, process_index, process_count):
            continue
        batch.append((i, rec))
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def hash_range_for_shard(
    shard: int, n_shards: int, span: int = 1 << 64
) -> Tuple[int, int]:
    """[lo, hi) u64 hash range owned by a shard (murmur is uniform, so
    equal ranges balance).

    ``span`` is the occupied hash space: the FracMinHash scaled filter
    keeps only hashes <= max_hash(scaled), so sharding passes
    ``max_hash_for_scaled(scaled) + 1`` — splitting the full u64 line
    would leave every shard above 2^64/scaled empty."""
    width = span // n_shards
    lo = shard * width
    hi = (shard + 1) * width if shard < n_shards - 1 else span
    return lo, hi


def shard_of_hash(mins: np.ndarray, n_shards: int, span: int = 1 << 64) -> np.ndarray:
    """Owning shard of each u64 hash under ``hash_range_for_shard``
    (vectorized; ``searchsorted`` on uint64 bounds, so the order is
    unsigned)."""
    if n_shards == 1:
        return np.zeros(len(mins), np.int64)
    bounds = np.asarray(
        [hash_range_for_shard(d, n_shards, span)[0] for d in range(1, n_shards)],
        np.uint64,
    )
    return np.searchsorted(bounds, np.asarray(mins, np.uint64), side="right")


# ----------------------------------------------------------------------
# signature-shard exchange: pack each process's sketches into flat
# arrays, all-gather, merge back in global record order. Pure functions,
# so the merge is testable without a process group.
# ----------------------------------------------------------------------


def _name_blob(signatures) -> Tuple[np.ndarray, np.ndarray]:
    """UTF-8 names as one uint8 blob + (n+1,) int64 offsets."""
    name_bytes = [s.name.encode("utf-8") for s in signatures]
    name_off = np.zeros(len(name_bytes) + 1, np.int64)
    np.cumsum(np.asarray([len(b) for b in name_bytes], np.int64), out=name_off[1:])
    return np.frombuffer(b"".join(name_bytes), np.uint8).copy(), name_off


def pack_local_shard(ordinals: List[int], signatures) -> dict:
    """Flatten one process's (ordinal, Signature) shard into numpy arrays
    (the only types the all-gather moves)."""
    names, name_off = _name_blob(signatures)
    sk_off = np.zeros(len(signatures) + 1, np.int64)
    np.cumsum(np.asarray([len(s.mins) for s in signatures], np.int64), out=sk_off[1:])
    return {
        "ordinals": np.asarray(ordinals, np.int64),
        "names": names,
        "name_offsets": name_off,
        "mins": (
            np.concatenate([s.mins for s in signatures])
            if signatures
            else np.zeros(0, np.uint64)
        ),
        "abundances": (
            np.concatenate([s.abundances for s in signatures])
            if signatures
            else np.zeros(0, np.int64)
        ),
        "sketch_offsets": sk_off,
    }


def merge_shards(payloads: List[dict], config, source_fasta: str = "", device=None):
    """Merge every process's packed shard into one ProteomeIndex in
    global record order (the inverse of the round-robin split — equal
    bit for bit to a single-process build). ``device`` is the merged
    index's (default: the CUDA device)."""
    from ..core.index import ProteomeIndex
    from ..core.signature import Signature

    entries = []
    for p in payloads:
        names_blob = p["names"].tobytes()
        no, so = p["name_offsets"], p["sketch_offsets"]
        for i, ordinal in enumerate(p["ordinals"].tolist()):
            entries.append(
                (
                    ordinal,
                    Signature(
                        name=names_blob[no[i] : no[i + 1]].decode("utf-8"),
                        mins=p["mins"][so[i] : so[i + 1]],
                        abundances=p["abundances"][so[i] : so[i + 1]],
                        ksize=config.ksize,
                        scaled=config.scaled,
                        moltype=config.moltype,
                        filename=source_fasta,
                    ),
                )
            )
    entries.sort(key=lambda e: e[0])
    if [e[0] for e in entries] != list(range(len(entries))):
        raise RuntimeError(
            "multi-host merge: record ordinals are not a dense 0..N-1 "
            "range — a host shard is missing or duplicated"
        )
    return ProteomeIndex.from_signatures(
        [e[1] for e in entries], config, source_fasta=source_fasta, device=device
    )


# what this process has exchanged so far: its own payload bytes, those it
# received from the other ranks (padding not counted), and the seconds
# spent inside the all-gathers
exchange_stats = {"bytes_sent": 0, "bytes_received": 0, "seconds": 0.0}


def _allgather_payloads(local: dict) -> List[dict]:
    """Exchange packed shards across the process group.

    One all-gather of the fields' byte sizes, then one padded ``uint8``
    all-gather per field, fields in sorted key order; each gathered
    field is viewed again in the dtype of the local one. The byte view
    is the transport for every dtype: nothing is converted on the way.
    With one process this returns ``[local]`` and touches no group.
    ``exchange_stats`` adds up what went through here."""
    import time

    dist = _dist()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [local]
    t0 = time.perf_counter()
    world, me = dist.get_world_size(), dist.get_rank()
    keys = sorted(local)
    byte_views = {k: np.ascontiguousarray(local[k]).reshape(-1).view(np.uint8) for k in keys}
    sizes = torch.tensor([len(byte_views[k]) for k in keys], dtype=torch.int64)
    gathered_sizes = [torch.zeros_like(sizes) for _ in range(world)]
    dist.all_gather(gathered_sizes, sizes)
    all_sizes = torch.stack(gathered_sizes).numpy()  # (P, K)
    payloads: List[dict] = [dict() for _ in range(world)]
    for ki, k in enumerate(keys):
        width = max(int(all_sizes[:, ki].max()), 1)
        padded = np.zeros(width, np.uint8)
        padded[: len(byte_views[k])] = byte_views[k]
        gathered = [torch.empty(width, dtype=torch.uint8) for _ in range(world)]
        dist.all_gather(gathered, torch.from_numpy(padded))
        for pi in range(world):
            n = int(all_sizes[pi, ki])
            payloads[pi][k] = gathered[pi].numpy()[:n].copy().view(local[k].dtype)
    exchange_stats["bytes_sent"] += int(all_sizes[me].sum())
    exchange_stats["bytes_received"] += int(all_sizes.sum() - all_sizes[me].sum())
    exchange_stats["seconds"] += time.perf_counter() - t0
    return payloads


def sketch_local_shard(
    fasta: str,
    config,
    rank: int,
    world: int,
    *,
    batch_size: int = 1000,
    ambiguity_policy: str = "first",
    device=None,
) -> Tuple[List[int], list]:
    """Stream and sketch THIS process's round-robin record shard on its
    device (``rank_device``). Returns (global ordinals, Signatures) —
    the data-parallel ingest stage of both multi-process builds. CUDA
    tensors take the sketch kernel, CPU tensors its plain version."""
    from ..core.alphabet import validate_resolve_batch
    from ..core.fasta import prefetch
    from ..core.index import sketch_batch_signatures

    dev = rank_device(device, rank)
    ordinals: List[int] = []
    signatures = []
    for batch in prefetch(iter_host_shard_batches(fasta, rank, world, batch_size)):
        names = [r.name for _o, r in batch]
        resolved = validate_resolve_batch(
            [r.seq for _o, r in batch], names, policy=ambiguity_policy
        )
        signatures.extend(
            sketch_batch_signatures(
                names, resolved, config, device=dev, filename=os.path.abspath(fasta)
            )
        )
        ordinals.extend(o for o, _r in batch)
    return ordinals, signatures


def build_distributed_index(
    fasta: str,
    config=None,
    *,
    batch_size: int = 1000,
    ambiguity_policy: str = "first",
    device=None,
):
    """Multi-process data-parallel index build — full-replica mode.

    Each process streams its round-robin record shard, sketches it on
    its device, and the shards are all-gathered so that every process
    returns the identical full ProteomeIndex (equal bit for bit to a
    single-process ``ProteomeIndex.build``). On one process this is the
    plain build with no communication.

    For indexes larger than one host's memory use
    ``parallel.sharded.build_sharded_index``, which keeps only this
    process's hash range resident."""
    from ..core.index import IndexConfig

    config = config or IndexConfig()
    rank, world = initialize_distributed()
    dev = rank_device(device, rank)
    ordinals, signatures = sketch_local_shard(
        fasta, config, rank, world,
        batch_size=batch_size, ambiguity_policy=ambiguity_policy, device=dev,
    )
    payloads = _allgather_payloads(pack_local_shard(ordinals, signatures))
    return merge_shards(payloads, config, source_fasta=fasta, device=dev)
