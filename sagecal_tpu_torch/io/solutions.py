"""Solution text files, byte-compatible with the reference format.

Copy of the writer, the reader and the resume validators of
``sagecal_tpu/io/solutions.py`` (that
module is stdlib + numpy, but importing ``sagecal_tpu`` pulls in JAX):

- '#' comment lines;
- first non-comment line: ``freq(MHz) bandwidth(MHz) time_interval(min)
  stations clusters effective_clusters``;
- then, per solution interval, 8N rows with 1+K columns: a repeating
  0..8N-1 counter followed by K effective-cluster columns.  Station s
  owns rows 8s..8s+7 = S0..S7 with ``J = [S0+jS1, S4+jS5; S2+jS3,
  S6+jS7]`` — the :func:`sagecal_tpu_torch.core.types.params_to_jones`
  ordering, so a column is literally a parameter vector.
"""

from __future__ import annotations

import os

import numpy as np


def write_header(fh, freq_hz: float, bw_hz: float, tint_min: float, nstations: int,
                 nclus: int, nclus_eff: int) -> None:
    fh.write("# solution file created by sagecal-tpu\n")
    fh.write("# freq(MHz) bandwidth(MHz) time_interval(min) stations clusters effective_clusters\n")
    fh.write(
        f"{freq_hz * 1e-6:f} {bw_hz * 1e-6:f} {tint_min:f} {nstations} {nclus} {nclus_eff}\n"
    )


def append_solutions(fh, jones_cols: np.ndarray, flush: bool = True) -> None:
    """Write one solution interval.  ``jones_cols``: (K, N, 2, 2) complex
    numpy — one column per effective cluster (cluster x hybrid chunk).
    The interval is written with a single ``fh.write`` and flushed."""
    K, N = jones_cols.shape[0], jones_cols.shape[1]
    z = np.stack(
        [
            jones_cols[..., 0, 0].real, jones_cols[..., 0, 0].imag,
            jones_cols[..., 1, 0].real, jones_cols[..., 1, 0].imag,
            jones_cols[..., 0, 1].real, jones_cols[..., 0, 1].imag,
            jones_cols[..., 1, 1].real, jones_cols[..., 1, 1].imag,
        ],
        axis=-1,
    )
    cols = z.reshape(K, 8 * N).T  # (8N, K)
    buf = "".join(
        str(r) + " " + " ".join(f"{x:e}" for x in cols[r]) + "\n"
        for r in range(8 * N)
    )
    fh.write(buf)
    if flush:
        fh.flush()


def _validate_interval_file(path: str, rows_per_interval_fn,
                            truncate: bool = False,
                            max_intervals=None) -> dict:
    """Shared torn-interval detector for the fixed-rows-per-interval
    text formats (solution files: 8N rows; global-Z files: Npoly*8N).

    A body row is valid iff it is newline-terminated, has the same
    column count as the first row, its leading counter sits at the
    expected cycle position, and every token parses as a float; the
    first invalid row (a torn tail from a mid-write kill) invalidates
    everything after it.  ``truncate=True`` atomically rewrites the
    file keeping only the complete leading intervals — resume re-opens
    it in append mode afterwards."""
    with open(path) as f:
        lines = f.readlines()
    header_end = None
    rows_per = None
    for i, ln in enumerate(lines):
        s = ln.strip()
        if not s or s.startswith("#"):
            continue
        rows_per = rows_per_interval_fn(s.split())
        header_end = i + 1
        break
    if rows_per is None or rows_per <= 0:
        raise ValueError(f"{path}: no parseable header line")
    body = lines[header_end:]
    ncols = None
    good = 0
    for ln in body:
        if not ln.endswith("\n"):
            break  # torn final line (no newline = interrupted write)
        toks = ln.split()
        if not toks:
            break
        if ncols is None:
            ncols = len(toks)
        if len(toks) != ncols:
            break
        if toks[0] != str(good % rows_per):
            break  # counter out of cycle: rows lost or interleaved
        try:
            for t in toks[1:]:
                float(t)
        except ValueError:
            break
        good += 1
    n_intervals = good // rows_per
    if max_intervals is not None and n_intervals > max_intervals:
        # intervals past the newest checkpoint: complete but about to
        # be recomputed by the resumed loop — drop them so the re-run
        # tile appends exactly once
        n_intervals = int(max_intervals)
    torn_rows = len(body) - n_intervals * rows_per
    result = {
        "n_intervals": n_intervals,
        "torn_rows": torn_rows,
        "rows_per_interval": rows_per,
        "truncated": False,
    }
    if truncate and torn_rows:
        keep = lines[: header_end + n_intervals * rows_per]
        tmp = f"{path}.tmp.validate"
        with open(tmp, "w") as f:
            f.writelines(keep)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        result["truncated"] = True
    return result


def validate_solutions(path: str, truncate: bool = False,
                       max_intervals=None) -> dict:
    """Detect (and optionally truncate) a partial trailing interval in
    a solution file.  Returns ``{"n_intervals", "torn_rows",
    "rows_per_interval", "truncated"}``.  Used by elastic resume to
    re-open a crashed run's solution file append-consistently: every
    interval is exactly 8N rows with a cycling 0..8N-1 counter, so any
    remainder is a torn tail from a mid-write kill.  ``max_intervals``
    additionally drops complete intervals past the resume point."""
    return _validate_interval_file(
        path, lambda tok: 8 * int(tok[3]), truncate=truncate,
        max_intervals=max_intervals)


def validate_global_z(path: str, truncate: bool = False,
                      max_intervals=None) -> dict:
    """:func:`validate_solutions` for the distributed app's global-Z
    file (header ``freq(MHz) npoly stations clusters eff``; one
    timeslot = ``npoly * 8N`` rows)."""
    return _validate_interval_file(
        path, lambda tok: int(tok[1]) * 8 * int(tok[2]), truncate=truncate,
        max_intervals=max_intervals)


def read_solutions(path: str):
    """Read a solution file -> (meta dict, (ntiles, K, N, 2, 2) complex)."""
    meta = None
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if meta is None:
                meta = {
                    "freq_hz": float(tok[0]) * 1e6,
                    "bw_hz": float(tok[1]) * 1e6,
                    "tint_min": float(tok[2]),
                    "nstations": int(tok[3]),
                    "nclus": int(tok[4]),
                    "nclus_eff": int(tok[5]),
                }
                continue
            rows.append([float(x) for x in tok[1:]])
    N = meta["nstations"]
    arr = np.asarray(rows)  # (ntiles*8N, K)
    K = arr.shape[1]
    ntiles = arr.shape[0] // (8 * N)
    a = arr.reshape(ntiles, N, 8, K).transpose(0, 3, 1, 2)  # (ntiles, K, N, 8)
    jones = np.empty((ntiles, K, N, 2, 2), np.complex128)
    jones[..., 0, 0] = a[..., 0] + 1j * a[..., 1]
    jones[..., 1, 0] = a[..., 2] + 1j * a[..., 3]
    jones[..., 0, 1] = a[..., 4] + 1j * a[..., 5]
    jones[..., 1, 1] = a[..., 6] + 1j * a[..., 7]
    return meta, jones
