"""Multi-process (multi-host) execution layer.

The reference distributes across nodes with MPI; this framework distributes
with a multi-process JAX device mesh.  The mapping (SURVEY.md §2.3):

  MPI_Init_thread / nranks / rank (main_real.cpp:17-19)
      -> :func:`initialize` (jax.distributed) + jax.process_index/count
  divide_work block partition (utilities.cpp:259-291)
      -> :func:`divide_work` (same contiguous-block semantics) and the
         equal padded-axis device partition the mesh induces
  per-rank MPI-IO slab read at offset 3 + S*mbytes (data.cpp:201-234)
      -> :func:`load_bed_words_global`: every process reads ONLY the byte
         ranges of the markers its addressable devices own (through the
         native pread loader), assembled into one global jax.Array with
         jax.make_array_from_callback
  MPI_Allreduce of N-vector partial products (data.cpp:928)
      -> lax.psum over the "m" mesh axis inside the matvecs (data.fns);
         identical code single- and multi-process
  mpi_store_vec_to_file offset-S shard writes (utilities.cpp:293-301)
      -> :func:`write_m_global`: each process writes its addressable
         shards of the global padded M-vector at their global offsets

Single-process runs go through the same helpers (a fully-addressable array
is just the degenerate case), so there is one code path to test.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from gvamp.io import vecio

_initialized = False


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> int:
    """Join the multi-process cluster; returns this process's index.

    Explicit arguments win; otherwise the GVAMP_COORDINATOR / GVAMP_NPROCS /
    GVAMP_PROC_ID environment variables; otherwise fully automatic discovery
    (cluster environment such as SLURM / OMPI), jax.distributed's default.
    Replaces the reference's MPI_Init_thread (main_real.cpp:17-19).
    """
    global _initialized
    import jax

    if _initialized:
        return jax.process_index()
    kw = {}
    coordinator = coordinator or os.environ.get("GVAMP_COORDINATOR")
    if coordinator:
        kw["coordinator_address"] = coordinator
    num_processes = num_processes or _env_int("GVAMP_NPROCS")
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    process_id = process_id if process_id is not None else _env_int("GVAMP_PROC_ID")
    if process_id is not None:
        kw["process_id"] = int(process_id)
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)
    _initialized = True
    return jax.process_index()


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def is_main() -> bool:
    import jax
    return jax.process_index() == 0


def is_multiprocess(mesh) -> bool:
    """True when the mesh spans devices of more than one process."""
    if mesh is None:
        return False
    procs = {d.process_index for d in np.asarray(mesh.devices).flat}
    return len(procs) > 1


def divide_work(mt: int, nranks: int):
    """Contiguous block partition of mt markers over nranks.

    Reference semantics (utilities.cpp:259-291): rank i gets
    mt // nranks markers, +1 for the first mt % nranks ranks.
    Returns (starts, counts) int arrays of length nranks.
    """
    base, rem = divmod(mt, nranks)
    counts = np.full(nranks, base, dtype=np.int64)
    counts[:rem] += 1
    starts = np.zeros(nranks, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    return starts, counts


# ---------------------------------------------------------------------------
# global-array assembly (the MPI-IO read analog)
# ---------------------------------------------------------------------------


def make_words_global(mesh, n_words: int, mpad: int,
                      shard_loader: Callable[[int, int], np.ndarray]):
    """Assemble the global uint32[n_words, Mpad] packed matrix.

    ``shard_loader(c0, width)`` must return the word columns [c0, c0+width)
    — it is invoked once per addressable device shard, so each process only
    touches its own byte ranges (the divide_work/MPI-IO analog).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(None, "m"))

    def cb(index):
        cols = index[1]
        c0 = 0 if cols.start is None else int(cols.start)
        c1 = mpad if cols.stop is None else int(cols.stop)
        return shard_loader(c0, c1 - c0)

    return jax.make_array_from_callback((n_words, mpad), sh, cb)


def load_bed_words_global(bed_path: str, N: int, M: int, S: int,
                          n_words: int, mpad: int, mesh):
    """Per-shard .bed byte-range reads -> global sharded word matrix.

    Device shard columns [c0, c1) cover real markers
    [S + c0, S + min(c1, M)); the rest is 0x55 padding (decodes to zero).
    """
    from gvamp import native
    from gvamp.io import plink
    from gvamp.ops.layout import PlanarLayout

    def loader(c0: int, width: int) -> np.ndarray:
        m_real = max(0, min(M, c0 + width) - c0)
        if m_real == 0:
            return np.full((n_words, width), 0x55555555, dtype=np.uint32)
        w = native.read_bed_words(bed_path, N, m_real, S + c0, n_words, width)
        if w is None:
            lay = PlanarLayout(N=N, n_words=n_words)
            bed = plink.read_bed_slab(bed_path, N, m_real, S + c0)
            w = np.full((n_words, width), 0x55555555, dtype=np.uint32)
            w[:, :m_real] = lay.pack_words(bed).T
        return w

    return make_words_global(mesh, n_words, mpad, loader)


def words_global_from_host(words_np: np.ndarray, mesh):
    """Full host word matrix (identical on every process) -> global array."""
    n_words, mpad = words_np.shape
    return make_words_global(mesh, n_words, mpad,
                             lambda c0, width: words_np[:, c0:c0 + width])


# ---------------------------------------------------------------------------
# host fetches and shard-wise I/O (the mpi_store_vec analog)
# ---------------------------------------------------------------------------


def to_numpy(x) -> np.ndarray:
    """Fetch any array to host, resharding to replicated first if the input
    is a multi-process sharded jax.Array (one all-gather over ICI/DCN)."""
    import jax

    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = x.sharding.mesh
        x = jax.jit(lambda v: v,
                    out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(x)


def write_m_global(path: str, x, M: int, s_offset: int = 0,
                   scale: float = 1.0) -> None:
    """Write the real-marker prefix [0, M) of a (possibly sharded, padded)
    M-space vector as float64 at element offset ``s_offset``.

    Each process writes only its addressable shards at their global offsets
    — the analog of mpi_store_vec_to_file's per-rank MPI_File_set_view at
    offset S (utilities.cpp:293-301).  Works identically single-process.
    """
    import jax

    if not isinstance(x, jax.Array):
        if is_main():
            vecio.write_bin_shard(path, np.asarray(x)[:M] * scale, s_offset)
        return
    seen = set()
    for sh in x.addressable_shards:
        idx = sh.index[0] if isinstance(sh.index, tuple) else sh.index
        c0 = 0 if idx.start is None else int(idx.start)
        if c0 in seen:  # replicated copies on several local devices
            continue
        seen.add(c0)
        data = np.asarray(sh.data)
        hi = min(c0 + data.shape[0], M)
        if hi <= c0:
            continue
        vecio.write_bin_shard(path, np.asarray(data[: hi - c0],
                                               dtype=np.float64) * scale,
                              s_offset + c0)


def barrier(name: str = "gvamp") -> None:
    """Cross-process synchronization point (MPI_Barrier analog) — e.g. after
    shard-wise file writes, before another process reads the file."""
    import jax

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)
