"""HDF5 time-series store for solution snapshots.

File-format parity with the reference (KSFD/ksfdtimeseries.py:73-671):

- file naming '{name}s{size}r{rank}.h5' (single-controller JAX runs
  write s1r0; the read path also accepts any s<size>r<rank> file and
  the legacy '{name}MPI.h5'),
- datasets 'data<k>' with attrs k and t, index datasets times/ks/order,
- '/info' group for user metadata, '/grid/*' self-description so a
  reader can reconstruct the Grid without the options file,
- linear interpolation retrieve_by_time, temp_close/reopen crash
  safety, open retries for flaky network filesystems.

Additions here: '/solver_state' (t, dt, lastvart, JAX PRNG key,
step counter) written by the checkpoint monitor so resume is bit-exact
— the reference restores only t/dt/lastvart and restarts its RNG from
the seed (SURVEY §5.4) — and the VIRTUAL SLAB VIEW: a single-process
reader pointed at a multi-rank slab set ('{name}s<N>r<k>.h5',
complete for ranks 0..N-1) opens the whole set as ONE logical global
series, no tsmerge pass needed.  This is the working '--mpiok'
semantics; the reference's parallel-HDF5 attempt is declared
broken/deadlocking (/root/reference/ksfdsolver2.py:80-89,
KSFD/ksfdtimeseries.py:17-27).
"""

import gc
import os
import re
import time
import traceback

import numpy as np

from ..utils.debug import logger
from ..utils.exceptions import KSFDException
from ..grid import Grid

logSERIES = logger("SERIES")

__all__ = ["TimeSeries", "Gatherer", "parse_filename"]

_GRID_ATTRS = [
    "dim",
    "dof",
    "nps",
    "bounds",
    "spacing",
    "order",
    "stencil_width",
]


def parse_filename(filename):
    """'bases2r1.h5' -> ('base', 2, 1, False); '...MPI.h5' -> mpi form."""
    res = re.fullmatch(r"(.*)MPI\.h5", filename)
    if res:
        return (res[1], 1, 0, True)
    res = re.fullmatch(r"(.*)s(\d+)r(\d+)\.h5", filename)
    if res:
        return (res[1], int(res[2]), int(res[3]), False)
    raise ValueError("Couldn't parse filename {f}".format(f=filename))


class TimeSeries:
    """Snapshot store for state arrays of shape grid.Vshape."""

    def __init__(
        self,
        basename,
        grid=None,
        mode="r+",
        size=1,
        rank=0,
        retries=0,
        retry_interval=60,
        mpiok=False,
        ranges=None,
    ):
        """Open or create a time series.

        basename: filename prefix (directories are created as needed).
        grid: required when creating; read from '/grid' otherwise.
        mode: h5py file mode ('r', 'r+', 'w', 'a').
        retries/retry_interval: open-retry loop for flaky filesystems
            (reference: KSFD/ksfdtimeseries.py:405-464).
        size/rank/mpiok: accepted for filename-protocol compatibility.
        ranges: ((lo, hi), ...) per spatial axis — create a SLAB file
            holding only that block of the global grid (the analog of
            the reference's per-rank files, KSFD/ksfdtimeseries.py:
            188-243).  Snapshots then have local shape; '/ranges' is
            written so Gatherer/tsmerge can reassemble the global
            series.  Pass size=<nprocs> rank=<this process>.
        """
        self.basename = basename
        self._size = size
        self._rank = rank
        self._mode = mode
        self.ranges = tuple(tuple(int(x) for x in r) for r in ranges) \
            if ranges is not None else None
        self.retries = retries
        self.retry_interval = retry_interval
        self.filename = self._get_filename(basename, size, rank, mode)
        if self.creating:
            dirname = os.path.dirname(os.path.abspath(self.filename))
            os.makedirs(dirname, exist_ok=True)
        self._tsf = self.open_with_retry()
        _ = self.info  # ensure /info exists
        if "times" in self.tsf:
            self.ts = np.array(self.tsf["times"][()])
            try:
                self.ks = np.array(self.tsf["ks"][()])
            except KeyError:
                self.ks = np.arange(len(self.ts))
            self.order = np.array(self.tsf["order"][()])
        else:
            self.ts = np.array([], dtype=float)
            self.ks = np.array([], dtype=int)
            self.order = np.array([], dtype=int)
        self.lastk = int(self.ks.max()) if self.ks.size else -1
        self.sorted = False
        if grid is not None:
            self.set_grid(grid)
            if self.mode != "r":
                self.grid_save()
        else:
            self.grid_load()
        if self.ranges is not None and self.mode != "r":
            self.try_to_set("ranges", np.asarray(self.ranges, dtype=np.int64))
        elif self.ranges is None:
            # reference-format files store the owned slab at
            # /grid/ranges (KSFD/ksfdtimeseries.py grid_save attrs)
            for key in ("ranges", "grid/ranges"):
                if key in self.tsf:
                    self.ranges = tuple(
                        tuple(int(x) for x in r)
                        for r in np.asarray(self.tsf[key][()])
                    )
                    break
        self._slabs = None
        if getattr(self, "_slab_files", None):
            self._open_slabs()
        self.tsf.flush()

    @property
    def local_shape(self):
        """Shape of one stored snapshot: the slab block, or grid.Vshape."""
        if self.ranges is None:
            return self.grid.Vshape
        return (self.grid.dof,) + tuple(hi - lo for lo, hi in self.ranges)

    # -- virtual slab view (working '--mpiok' read semantics) ----------
    def _open_slabs(self):
        """Open every file of the slab set; the series then presents
        the GLOBAL grid (self.ranges -> None) and retrieve_by_number
        assembles snapshots across slabs."""
        slabs = []
        for f in self._slab_files:
            h = self.open_with_retry(fname=f, mode="r")
            rng = None
            for key in ("ranges", "grid/ranges"):
                if key in h:
                    rng = tuple(
                        tuple(int(x) for x in r)
                        for r in np.asarray(h[key][()])
                    )
                    break
            if rng is None:
                # a rangeless member means the set is not a slab
                # decomposition after all; fall back to plain reads
                for hh, _ in slabs:
                    hh.close()
                h.close()
                self._slab_files = None
                return
            slabs.append((h, rng))
        self._slabs = slabs
        self.ranges = None
        logSERIES(
            "virtual slab view over", len(slabs), "files:",
            self._slab_files,
        )

    @property
    def virtual(self):
        """True when this reader presents a multi-rank slab set as one
        logical global series."""
        return bool(getattr(self, "_slabs", None))

    # -- filename protocol ---------------------------------------------
    def _get_filename(self, basename, size, rank, mode):
        name_self = "{n}s{s}r{r}.h5".format(n=basename, s=size, r=rank)
        name_seq = "{n}s1r0.h5".format(n=basename)
        name_mpi = "{n}MPI.h5".format(n=basename)
        writing = mode[0] in ("w", "x")
        self.creating = writing
        self._slab_files = None
        if writing:
            return name_self
        if os.path.isfile(name_self):
            return name_self
        if mode[0] == "r" or mode == "a":
            for cand in (name_seq, name_mpi):
                if os.path.isfile(cand):
                    return cand
            # VIRTUAL SLAB VIEW (the working '--mpiok' semantics the
            # reference never achieved, /root/reference/ksfdsolver2.py:
            # 80-89): a single-process reader pointed at a multi-rank
            # slab set opens the COMPLETE set as one logical global
            # series — no tsmerge pass needed.  Engaged only for
            # single-process readers (size == 1): multi-process
            # readers keep the strict own-slab semantics resume
            # depends on.
            import glob

            if size == 1 and mode[0] == "r":
                sets = {}
                for f in sorted(glob.glob(basename + "s*r*.h5")):
                    try:
                        _, fsize, frank, _ = parse_filename(
                            os.path.basename(f)
                        )
                    except ValueError:
                        continue
                    sets.setdefault(fsize, {})[frank] = f
                for fsize in sorted(sets, reverse=True):
                    ranks = sets[fsize]
                    if fsize > 1 and sorted(ranks) == list(range(fsize)):
                        self._slab_files = [
                            ranks[r] for r in range(fsize)
                        ]
                        return ranks[0]
            # a single s<size>r0 file from another run size is readable
            # when it holds the full grid; glob for one as last resort
            cands = sorted(glob.glob(basename + "s*r0.h5"))
            if cands:
                return cands[0]
        self.creating = mode != "r"
        return name_self

    def open_with_retry(self, fname=None, mode=None):
        # imported here: only runs that save, checkpoint or read a
        # series need h5py
        import h5py

        fname = fname or self.filename
        mode = mode or self.mode
        try:
            return h5py.File(fname, mode=mode)
        except OSError:
            retries_left = self.retries
            if retries_left <= 0:
                raise
            while retries_left > 0:
                logSERIES(
                    "open failed, retries left:", retries_left,
                    traceback.format_exc(limit=1),
                )
                time.sleep(self.retry_interval)
                try:
                    return h5py.File(fname, mode=mode)
                except OSError:
                    if retries_left <= 1:
                        raise
                retries_left -= 1

    # -- grid self-description -------------------------------------------
    def set_grid(self, grid):
        self._grid = grid

    def grid_save(self):
        g = self.grid
        state = g.state()
        for k, v in state.items():
            self.try_to_set("/grid/" + k, v)
        for a in _GRID_ATTRS:
            self.try_to_set("/grid/" + a, getattr(g, a))

    def grid_load(self):
        if "grid" not in self.tsf:
            raise KSFDException(
                "no /grid group in {f}; pass grid=".format(f=self.filename)
            )
        gg = self.tsf["grid"]
        kwargs = {}
        for k in (
            "dim", "width", "height", "depth", "nx", "ny", "nz", "dof",
            "order", "stencil_width",
        ):
            if k in gg:
                v = gg[k][()]
                kwargs[k] = v.item() if np.isscalar(v) or v.shape == () else v
        # Reference-format files (KSFD/ksfdtimeseries.py:253-262) store
        # the per-axis sizes as 'nps' and the physical extents as
        # 'bounds' instead of nx/ny/nz and width/height/depth; accept
        # those so reference-written series load (the file-protocol
        # parity claim of this module).  We write BOTH key sets.
        if "nx" not in kwargs and "nps" in gg:
            nps = np.asarray(gg["nps"][()]).ravel()
            for name, i in (("nx", 0), ("ny", 1), ("nz", 2)):
                if i < len(nps):
                    kwargs[name] = int(nps[i])
        if "width" not in kwargs and "bounds" in gg:
            bounds = np.asarray(gg["bounds"][()]).ravel()
            for name, i in (("width", 0), ("height", 1), ("depth", 2)):
                if i < len(bounds):
                    kwargs[name] = float(bounds[i])
        self._grid = Grid(**kwargs)

    # -- plumbing ---------------------------------------------------------
    @property
    def info(self):
        if not hasattr(self, "_info") or not self._info:
            self._info = self.tsf.require_group("/info")
        return self._info

    @property
    def tsf(self):
        return self._tsf

    @property
    def tsFile(self):
        return getattr(self, "_tsf", None) and bool(self._tsf)

    @property
    def mode(self):
        return self._mode

    @property
    def size(self):
        return self._size

    @property
    def rank(self):
        return self._rank

    @property
    def grid(self):
        return self._grid

    def try_to_set(self, key, val):
        if self.mode == "r":
            return
        try:
            del self.tsf[key]
        except KeyError:
            pass
        try:
            self.tsf[key] = val
        except (ValueError, TypeError):
            pass

    def _sort(self):
        if getattr(self, "sorted", False):
            return
        self.try_to_set("times", self.ts)
        self.order = self.ts.argsort()
        self.try_to_set("order", self.order)
        self.sts = np.sort(self.ts)
        self.try_to_set("ks", self.ks)
        self.try_to_set("lastk", self.lastk)
        self.sorted = True

    def flush(self):
        self._sort()
        self.tsf.flush()

    def _close_slabs(self):
        for h, _ in getattr(self, "_slabs", None) or ():
            try:
                h.close()
            except Exception:
                pass
        self._slabs = None

    def temp_close(self):
        """Close keeping state; reopen() resumes.  Crash-safe saving."""
        self._sort()
        self._close_slabs()
        self.tsf.close()
        self._tsf = None
        self._info = None

    def reopen(self):
        mode = self.mode if self.mode == "r" else "r+"
        self._tsf = self.open_with_retry(mode=mode)
        if getattr(self, "_slab_files", None):
            self._open_slabs()

    def close(self):
        if not getattr(self, "_tsf", None):
            self.reopen()
        self._sort()
        self._close_slabs()
        self.tsf.close()
        self._tsf = None
        self._info = None
        gc.collect()

    # -- solver state (bit-exact resume) -----------------------------------
    def save_solver_state(self, t, dt, lastvart=None, rng_key=None, k=None):
        self.try_to_set("/solver_state/t", float(t))
        self.try_to_set("/solver_state/dt", float(dt))
        if lastvart is not None:
            self.try_to_set("/solver_state/lastvart", float(lastvart))
        if rng_key is not None:
            import jax

            self.try_to_set(
                "/solver_state/rng_key",
                np.asarray(jax.random.key_data(rng_key)),
            )
        if k is not None:
            self.try_to_set("/solver_state/k", int(k))
        # reference-compatible locations (ksfdts.py:418-431)
        self.try_to_set("/info/dt", float(dt))
        if lastvart is not None:
            self.try_to_set("/info/lastvart", float(lastvart))

    def load_solver_state(self):
        out = {}
        if "solver_state" in self.tsf:
            ss = self.tsf["solver_state"]
            for k in ("t", "dt", "lastvart", "k"):
                if k in ss:
                    out[k] = ss[k][()].item()
            if "rng_key" in ss:
                import jax

                out["rng_key"] = jax.random.wrap_key_data(
                    np.asarray(ss["rng_key"][()])
                )
        else:
            if "dt" in self.info:
                out["dt"] = float(self.info["dt"][()])
            if "lastvart" in self.info:
                out["lastvart"] = float(self.info["lastvart"][()])
        return out

    # -- snapshots ----------------------------------------------------------
    def store(self, data, t, k=None):
        vals = np.asarray(data).reshape(self.local_shape)
        if k is None:
            k = self.lastk + 1
        self.lastk = k
        self.ks = np.append(self.ks, k)
        self.ts = np.append(self.ts, t)
        key = "data" + str(k)
        if key in self.tsf:
            dset = self.tsf[key]
        else:
            dset = self.tsf.create_dataset(
                key, self.local_shape, dtype=vals.dtype
            )
        dset[...] = vals
        dset.attrs["k"] = k
        dset.attrs["t"] = t
        self.sorted = False
        self.tsf.flush()

    def store_slice(self, ranges, data, t, tol=1e-7):
        """Write a spatial slice into the snapshot nearest time t,
        creating it if no time within tol exists (merge tool support;
        reference: KSFD/ksfdtimeseries.py:511-549)."""
        shape = (self.grid.dof,) + tuple(r[1] - r[0] for r in ranges)
        slc = (slice(None),) + tuple(slice(*r) for r in ranges)
        vals = np.asarray(data).reshape(shape)
        na, nb, ta, tb = self.find_time(t)
        n, tn = (na, ta) if abs(t - ta) <= abs(tb - t) else (nb, tb)
        # A slice starts a new snapshot iff the series is empty or no
        # stored time matches within tol.  (n is a snapshot NUMBER, not
        # a position — never compare it against the count.)
        is_new = self.sts.size == 0 or (
            abs(t - tn) / max(abs(t), abs(tn), 1e-300) > tol
        )
        if is_new:
            k = self.lastk + 1
            self.lastk = k
            self.ks = np.append(self.ks, k)
            self.ts = np.append(self.ts, t)
            dset = self.tsf.create_dataset(
                "data" + str(k), self.grid.Vshape, dtype=vals.dtype
            )
            dset.attrs["k"] = k
            dset.attrs["t"] = t
            self.sorted = False
        else:
            dset = self.tsf["data" + str(n)]
        dset[slc] = vals
        self.tsf.flush()

    def times(self):
        self._sort()
        return self.ts

    def steps(self):
        self._sort()
        return self.ks

    def sorted_times(self):
        self._sort()
        return self.sts

    def sorted_steps(self):
        self._sort()
        return self.order

    def retrieve_by_number(self, k):
        if self.virtual:
            out = None
            key = "data" + str(k)
            for h, rng in self._slabs:
                vals = np.asarray(h[key])
                if out is None:
                    out = np.empty(self.grid.Vshape, dtype=vals.dtype)
                slc = (slice(None),) + tuple(slice(*r) for r in rng)
                out[slc] = vals
            return out
        return np.array(self.tsf["data" + str(k)])

    def find_time(self, t):
        """Numbers and times of the snapshots flanking t.

        Returns (na, nb, ta, tb); na == nb when t matches exactly or
        lies outside the stored range.
        """
        self._sort()
        if self.sts.size == 0:
            return (0, 0, t - 1.0, t - 1.0)
        if t <= self.sts[0]:
            a = 0
            return (self.ks[self.order[a]], self.ks[self.order[a]],
                    self.sts[a], self.sts[a])
        if t >= self.sts[-1]:
            a = len(self.sts) - 1
            return (self.ks[self.order[a]], self.ks[self.order[a]],
                    self.sts[a], self.sts[a])
        b = int(self.sts.searchsorted(t))
        tb = self.sts[b]
        if tb == t:
            return (self.ks[self.order[b]], self.ks[self.order[b]], tb, tb)
        a = b - 1
        return (
            self.ks[self.order[a]],
            self.ks[self.order[b]],
            self.sts[a],
            self.sts[b],
        )

    def retrieve_by_time(self, t):
        """Snapshot at time t, linearly interpolated between stores."""
        na, nb, ta, tb = self.find_time(t)
        adata = self.retrieve_by_number(na)
        if na == nb:
            return adata
        bdata = self.retrieve_by_number(nb)
        return ((t - ta) * bdata + (tb - t) * adata) / (tb - ta)


class Gatherer:
    """Iterate over all per-rank files of one run prefix.

    The runtime writes one file per process (usually just s1r0),
    but this also reads multi-rank sets produced elsewhere
    (reference: KSFD/ksfdtimeseries.py:674-828).  Yields TimeSeries
    objects opened read-only, exposing .rank/.size and .ranges when
    present in the file.
    """

    def __init__(self, basename):
        import glob

        self.basename = basename
        pattern = basename + "s*r*.h5"
        files = sorted(glob.glob(pattern))
        if not files:
            if os.path.isfile(basename + "MPI.h5"):
                files = [basename + "MPI.h5"]
        if not files:
            raise KSFDException(
                "no files match {p}".format(p=pattern)
            )
        self.files = files

    def __iter__(self):
        for f in self.files:
            base, size, rank, mpi = parse_filename(os.path.basename(f))
            ts = TimeSeries(
                os.path.join(os.path.dirname(f), base), mode="r",
                size=size, rank=rank,
            )
            ts._size, ts._rank = size, rank
            # TimeSeries.__init__ already loaded 'ranges' (ours) or
            # '/grid/ranges' (reference-written slab files); default a
            # rangeless single file to the full grid extent.
            if ts.ranges is None:
                ts.ranges = tuple((0, int(n)) for n in ts.grid.nps)
            yield ts
