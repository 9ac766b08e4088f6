"""Visibility dataset I/O: tiled loading, channel averaging, writing back
(counterpart of ``sagecal_tpu/io/dataset.py``).

The container is the reference's HDF5 ``vis.h5`` (layout below).
``h5py`` is imported only where a file is opened, and every opener is a
parameter: :class:`VisDataset`, :class:`TilePrefetcher` and
:func:`create_dataset` take ``open_file``, a callable ``(path, mode)``
returning an ``h5py.File``-like object (None: ``h5py.File``), so the
module and the apps import and run without ``h5py``
(``io/memh5.py::MemFile`` is the in-memory stand-in).

Reproduced semantics: ``tilesz`` timeslots a tile; channel averaging
with the "more than half the channels unflagged" rule (rows failing it
get mask 0); the uv cut in wavelengths at ``freq0``; u, v, w stored in
metres and returned in seconds; residuals written back to a chosen
column.  Everything up to the tensors is the reference's numpy, so both
packages load the same numbers from one file.

Layout: ``/u /v /w`` (ntime, nbase) float64 metres; ``/ant_p /ant_q``
(nbase,) int32; ``/vis`` (ntime, nbase, nchan, 2, 2) complex; ``/flag``
(ntime, nbase, nchan) bool; ``/freqs`` (nchan,) float64; attributes
freq0, deltaf, deltat, ra0, dec0, nstations, time_jd0; an optional
``/beam`` group (the station geometry of the beam-aware path:
longitude, latitude (N,), elem_x, elem_y, elem_z, elem_mask (N, Kmax);
attributes b_ra0, b_dec0, bf_type, beam_f0) read by
:meth:`VisDataset.load_beam`.  The MeasurementSet bridges
``ms_to_h5``/``h5_to_ms`` wait for A10.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from sagecal_tpu_torch.core.types import C0, VisData
from sagecal_tpu_torch.device import resolve_device
from sagecal_tpu_torch.io.simulate import _torch_dtype


def _opener(open_file):
    if open_file is not None:
        return open_file
    import h5py

    return h5py.File


@dataclasses.dataclass
class DatasetMeta:
    nstations: int
    nbase: int
    ntime: int
    nchan: int
    freq0: float
    deltaf: float
    deltat: float
    ra0: float
    dec0: float
    freqs: np.ndarray
    time_jd0: float = 0.0


class VisDataset:
    """Tile-streaming reader/writer over a ``vis.h5`` container opened
    with ``open_file`` (module doc)."""

    def __init__(self, path: str, mode: str = "r", open_file=None):
        self.path = path
        self._f = _opener(open_file)(path, mode)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @property
    def meta(self) -> DatasetMeta:
        f = self._f
        return DatasetMeta(
            nstations=int(f.attrs["nstations"]),
            nbase=f["u"].shape[1],
            ntime=f["u"].shape[0],
            nchan=f["freqs"].shape[0],
            freq0=float(f.attrs["freq0"]),
            deltaf=float(f.attrs["deltaf"]),
            deltat=float(f.attrs["deltat"]),
            ra0=float(f.attrs["ra0"]),
            dec0=float(f.attrs["dec0"]),
            freqs=np.asarray(f["freqs"]),
            time_jd0=float(f.attrs.get("time_jd0", 0.0)),
        )

    def load_tile(self, t0: int, tilesz: int, average_channels: bool = True,
                  min_uvcut: float = 0.0, max_uvcut: float = 1e20,
                  dtype=np.float64, column: str = "vis",
                  device=None) -> VisData:
        """Timeslots [t0, t0 + tilesz) as a :class:`VisData` on ``device``
        (CUDA unless ``device="cpu"``).

        ``average_channels=True``: the solver's input, one channel, the
        mean over the channels unflagged where more than half are; False:
        the raw channels (the residual path's view).  ``column``: the
        input dataset ('vis', 'corrected', 'model', ...)."""
        f = self._f
        m = self.meta
        if column not in f:
            raise KeyError(
                f"{self.path}: no input column {column!r} "
                f"(available: {sorted(k for k in f.keys())})")
        dev = resolve_device(device)
        t1 = min(t0 + tilesz, m.ntime)
        nt = t1 - t0
        u = np.asarray(f["u"][t0:t1]).reshape(-1)  # (nt*nbase,)
        v = np.asarray(f["v"][t0:t1]).reshape(-1)
        w = np.asarray(f["w"][t0:t1]).reshape(-1)
        vis = np.asarray(f[column][t0:t1])  # (nt, nbase, nchan, 2, 2)
        flag = np.asarray(f["flag"][t0:t1])  # (nt, nbase, nchan)
        rows = nt * m.nbase
        vis = vis.reshape(rows, m.nchan, 2, 2)
        flag = flag.reshape(rows, m.nchan)
        ant_p = np.tile(np.asarray(f["ant_p"]), nt)
        ant_q = np.tile(np.asarray(f["ant_q"]), nt)
        time_idx = np.repeat(np.arange(nt), m.nbase)

        uvd = np.sqrt(u * u + v * v) / C0 * m.freq0  # wavelengths at freq0
        uvcut_bad = (uvd < min_uvcut) | (uvd > max_uvcut)

        rdt = _torch_dtype(dtype)
        if average_channels and m.nchan > 1:
            good = ~flag
            ngood = good.sum(axis=1)
            ok = ngood > m.nchan // 2
            wsum = np.where(good[..., None, None], vis, 0.0).sum(axis=1)
            x = np.where(ok[:, None, None],
                         wsum / np.maximum(ngood, 1)[:, None, None],
                         0.0)[:, None]  # (rows, 1, 2, 2)
            mask = (ok & ~uvcut_bad)[:, None]
            freqs = np.asarray([m.freq0])
            fd = m.deltaf
        else:
            x = vis
            mask = (~flag) & (~uvcut_bad[:, None])
            freqs = m.freqs
            fd = m.deltaf / max(m.nchan, 1)
        nch = x.shape[1]
        x_flat = np.moveaxis(x.reshape(rows, nch, 4), 0, -1)  # (F, 4, rows)
        cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
        as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a),
                                             dtype=dt).to(dev)
        return VisData(
            u=as_t(u / C0, rdt), v=as_t(v / C0, rdt), w=as_t(w / C0, rdt),
            ant_p=as_t(ant_p, torch.int64), ant_q=as_t(ant_q, torch.int64),
            vis=as_t(x_flat, cdt), mask=as_t(np.moveaxis(mask, 0, -1), rdt),
            freqs=as_t(freqs, rdt), time_idx=as_t(time_idx, torch.int64),
            freq0=m.freq0, deltaf=fd, deltat=m.deltat, tilesz=nt,
            nbase=m.nbase, nstations=m.nstations,
        )

    def load_beam(self, device=None):
        """The ``/beam`` group as (``ops.beam.StationGeometry``,
        ``ops.beam.BeamPointing``) with the geometry's float64 tensors on
        ``device`` (CUDA unless ``device="cpu"``), or None when the
        dataset has no such group."""
        if "beam" not in self._f:
            return None
        from sagecal_tpu_torch.ops.beam import BeamPointing, StationGeometry

        g = self._f["beam"]
        m = self.meta
        dev = resolve_device(device)
        f64 = lambda name: torch.as_tensor(  # noqa: E731
            np.asarray(g[name], np.float64)).to(dev)
        geom = StationGeometry(
            longitude=f64("longitude"), latitude=f64("latitude"),
            x=f64("elem_x"), y=f64("elem_y"), z=f64("elem_z"),
            elem_mask=f64("elem_mask"),
            bf_type=int(g.attrs.get("bf_type", 1)))
        pointing = BeamPointing(
            ra0=m.ra0, dec0=m.dec0,
            b_ra0=float(g.attrs.get("b_ra0", m.ra0)),
            b_dec0=float(g.attrs.get("b_dec0", m.dec0)),
            f0=float(g.attrs.get("beam_f0", m.freq0)))
        return geom, pointing

    def time_jd(self, t0: int, nt: int) -> np.ndarray:
        """Julian dates of timeslots [t0, t0 + nt) (the beam's epochs)."""
        m = self.meta
        return m.time_jd0 + (t0 + np.arange(nt)) * m.deltat / 86400.0

    def write_tile(self, t0: int, vis, column: str = "vis"):
        """Write (rows, nchan, 2, 2) visibilities (numpy, or a tensor,
        copied to the host) back at timeslot t0; ``column`` is created
        like ``/vis`` when absent."""
        if isinstance(vis, torch.Tensor):
            vis = vis.detach().cpu().numpy()
        m = self.meta
        nt = vis.shape[0] // m.nbase
        out = np.asarray(vis).reshape(nt, m.nbase, vis.shape[1], 2, 2)
        if column not in self._f:
            self._f.create_dataset(column, shape=self._f["vis"].shape,
                                   dtype=self._f["vis"].dtype,
                                   chunks=(1,) + self._f["vis"].shape[1:])
        self._f[column][t0:t0 + nt] = out

    def tiles(self, tilesz: int):
        """Tile start indices."""
        return range(0, self.meta.ntime, tilesz)


# Live prefetchers, so that a crash path can reap reader threads
# (:func:`cancel_active_prefetchers`); entries register in __enter__ and
# leave in close().
_ACTIVE_PREFETCHERS: list = []


def cancel_active_prefetchers() -> None:
    """Cancel and join every live :class:`TilePrefetcher` worker (bounded
    wait; the workers are daemon threads)."""
    for pf in list(_ACTIVE_PREFETCHERS):
        try:
            pf.cancel()
        except Exception:
            pass


class TilePrefetcher:
    """Background-thread tile prefetch: the next tile's read and host-side
    packing overlap the current tile's solve.

    The worker opens its own read-only handle (``open_file``) and loads
    each tile as CPU tensors (``device="cpu"``): it never touches CUDA,
    so every CUDA operation of a tile runs on the consuming thread, in
    one fixed order.  The consumer moves the tensors to its device.
    Usage::

        with TilePrefetcher(path, t0_list, [spec1, spec2], tilesz) as pf:
            for t0, (tile1, tile2) in pf:
                ...

    ``specs``: ``load_tile`` keyword dicts; each item carries one loaded
    VisData per spec, in order.  A failed open or load is raised in the
    consumer."""

    _SENTINEL = object()

    def __init__(self, path: str, t0_list, specs, tilesz: int,
                 depth: int = 1, open_file=None):
        import queue
        import threading

        self._path = path
        self._t0s = list(t0_list)
        self._specs = [dict(s) for s in specs]
        self._tilesz = tilesz
        self._open_file = open_file
        self._q = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False
        self._closed = False

    def _worker(self):
        ds = None
        try:
            ds = VisDataset(self._path, "r", self._open_file)
            for t0 in self._t0s:
                if self._stop.is_set():
                    return
                try:
                    loads = tuple(ds.load_tile(t0, self._tilesz, device="cpu",
                                               **spec)
                                  for spec in self._specs)
                except Exception as e:  # propagate into the consumer
                    self._q.put((t0, e))
                    return
                self._q.put((t0, loads))
        except Exception as e:
            # a failed open must reach the consumer, not deadlock it
            self._q.put((None, e))
        finally:
            if ds is not None:
                try:
                    ds.close()
                except Exception:
                    pass
            self._q.put(self._SENTINEL)

    def __enter__(self):
        self._thread.start()
        self._started = True
        if self not in _ACTIVE_PREFETCHERS:
            _ACTIVE_PREFETCHERS.append(self)
        return self

    def cancel(self, join_timeout: float = 2.0) -> None:
        """Stop the worker and drain its queue with a bounded wait."""
        self._stop.set()
        if not self._started:
            return
        deadline = _time.monotonic() + max(join_timeout, 0.1)
        while self._thread.is_alive() and _time.monotonic() < deadline:
            try:
                if self._q.get(timeout=0.1) is self._SENTINEL:
                    break
            except Exception:
                continue
        self._thread.join(timeout=max(deadline - _time.monotonic(), 0.1))

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        """Signal the worker, drain so it can exit early, join, and leave
        the registry.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            _ACTIVE_PREFETCHERS.remove(self)
        except ValueError:
            pass
        if self._started:
            while self._thread.is_alive():
                try:
                    if self._q.get(timeout=0.1) is self._SENTINEL:
                        break
                except Exception:
                    continue
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                import warnings
                warnings.warn(
                    f"TilePrefetcher worker for {self._path!r} did not exit "
                    "within 5 s of close; it still holds a read handle",
                    RuntimeWarning, stacklevel=2)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            t0, payload = item
            if isinstance(payload, Exception):
                raise payload
            yield t0, payload


def create_dataset(path: str, u, v, w, ant_p, ant_q, vis, flag, freqs,
                   nstations: int, deltaf: float, deltat: float = 1.0,
                   ra0: float = 0.0, dec0: float = 0.0, time_jd0: float = 0.0,
                   beam=None, open_file=None) -> None:
    """Write a ``vis.h5`` container (module doc's layout): u, v, w
    (ntime, nbase) metres; ant_p, ant_q (nbase,); vis (ntime, nbase,
    nchan, 2, 2); flag (ntime, nbase, nchan); freqs (nchan,).  ``beam``:
    a dict of longitude, latitude (N,), elem_x, elem_y, elem_z, elem_mask
    (N, Kmax) and optionally b_ra0, b_dec0, bf_type, beam_f0, stored as
    the ``/beam`` group."""
    with _opener(open_file)(path, "w") as f:
        for name, arr in (("u", u), ("v", v), ("w", w)):
            f.create_dataset(name, data=np.asarray(arr, np.float64),
                             chunks=(1, np.asarray(arr).shape[1]))
        f.create_dataset("ant_p", data=np.asarray(ant_p, np.int32))
        f.create_dataset("ant_q", data=np.asarray(ant_q, np.int32))
        va = np.asarray(vis)
        f.create_dataset("vis", data=va, chunks=(1,) + va.shape[1:])
        fa = np.asarray(flag, bool)
        f.create_dataset("flag", data=fa, chunks=(1,) + fa.shape[1:])
        fr = np.asarray(freqs, np.float64)
        f.create_dataset("freqs", data=fr)
        f.attrs["nstations"] = nstations
        f.attrs["freq0"] = float(np.mean(fr))
        f.attrs["deltaf"] = deltaf
        f.attrs["deltat"] = deltat
        f.attrs["ra0"] = ra0
        f.attrs["dec0"] = dec0
        f.attrs["time_jd0"] = time_jd0
        if beam is not None:
            write_beam_group(f, beam)


def write_beam_group(f, beam: dict) -> None:
    """Store ``beam`` (longitude, latitude (N,), elem_x, elem_y, elem_z,
    elem_mask (N, Kmax); optionally b_ra0, b_dec0, bf_type, beam_f0) as
    the ``/beam`` group of the open file ``f``."""
    g = f.create_group("beam")
    for k in ("longitude", "latitude", "elem_x", "elem_y", "elem_z",
              "elem_mask"):
        g.create_dataset(k, data=np.asarray(beam[k]))
    for k in ("b_ra0", "b_dec0", "bf_type", "beam_f0"):
        if k in beam:
            g.attrs[k] = beam[k]


def simulate_dataset(path: str, nstations: int = 8, ntime: int = 8,
                     nchan: int = 4, freq0: float = 150e6,
                     chan_bw: float = 180e3, clusters=None, jones=None,
                     noise_sigma: float = 0.0, seed: int = 0,
                     dec0: float = 0.9, with_beam: bool = False,
                     nelem: int = 24, open_file=None, device=None) -> None:
    """A synthetic ``vis.h5``: the reference's draws from numpy's
    ``default_rng(seed)`` in the reference's order (station layout, uvw
    track, noise), the sky model ``clusters`` (SourceBatch list, e.g.
    from ``io.skymodel.load_sky``) corrupted by ``jones`` (nclus, N, 2, 2)
    predicted on ``device`` (CUDA unless ``device="cpu"``) at float64
    u, v, w and frequencies, as the reference predicts them.
    ``with_beam``: a ``/beam`` group of ``nelem`` random dipoles a
    station in a 30 m disk, from ``default_rng(seed + 1)`` as the
    reference draws them (the model itself is unbeamed)."""
    from sagecal_tpu_torch.core.baselines import tile_baselines
    from sagecal_tpu_torch.io.simulate import station_layout, uvw_track
    from sagecal_tpu_torch.ops.rime import predict_model

    dev = resolve_device(device)
    nbase = nstations * (nstations - 1) // 2
    ant_p1, ant_q1, _ = tile_baselines(nstations, 1)
    xyz = station_layout(nstations, seed=seed)
    ap = np.tile(ant_p1, ntime)
    aq = np.tile(ant_q1, ntime)
    tidx = np.repeat(np.arange(ntime), nbase)
    us, vs, ws = uvw_track(xyz, ap, aq, tidx, dec0=dec0)  # seconds
    freqs = freq0 + chan_bw * (np.arange(nchan) - (nchan - 1) / 2.0)
    rng = np.random.default_rng(seed)
    if clusters is not None:
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64).to(dev)
        model = predict_model(
            f64(us), f64(vs), f64(ws), f64(freqs), clusters, 0.0, jones=jones,
            ant_p=torch.as_tensor(ap).to(dev),
            ant_q=torch.as_tensor(aq).to(dev))  # (nchan, 4, rows)
        rows = model.shape[-1]
        visr = model.permute(2, 0, 1).reshape(rows, nchan, 2, 2)
        visr = visr.detach().cpu().numpy()  # (rows, nchan, 2, 2) on disk
    else:
        visr = np.zeros((ntime * nbase, nchan, 2, 2), np.complex128)
    if noise_sigma > 0:
        visr = visr + noise_sigma * (
            rng.standard_normal(visr.shape)
            + 1j * rng.standard_normal(visr.shape))
    beam = None
    if with_beam:
        brng = np.random.default_rng(seed + 1)
        r = 30.0 * np.sqrt(brng.uniform(0.2, 1.0, (nstations, nelem)))
        th = brng.uniform(0, 2 * np.pi, (nstations, nelem))
        beam = dict(longitude=np.full(nstations, 0.12),
                    latitude=np.full(nstations, 0.92),
                    elem_x=r * np.cos(th), elem_y=r * np.sin(th),
                    elem_z=np.zeros((nstations, nelem)),
                    elem_mask=np.ones((nstations, nelem), bool),
                    b_ra0=0.0, b_dec0=dec0, bf_type=1, beam_f0=freq0)
    create_dataset(
        path, u=(us * C0).reshape(ntime, nbase),
        v=(vs * C0).reshape(ntime, nbase), w=(ws * C0).reshape(ntime, nbase),
        ant_p=ant_p1, ant_q=ant_q1,
        vis=visr.reshape(ntime, nbase, nchan, 2, 2),
        flag=np.zeros((ntime, nbase, nchan), bool), freqs=freqs,
        nstations=nstations, deltaf=chan_bw * nchan, dec0=dec0,
        time_jd0=2460000.5, beam=beam, open_file=open_file)
