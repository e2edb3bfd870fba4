"""Bucketed panel dispatch (port of ``render/dispatch.py``).

Panels pad into shape buckets keyed on ``(Tp, Ap, Ep, y_scale, z_scale,
percentiles, explicit, fused)``; each bucket is one collapse + quantize
program on the device, and ONE device-to-host copy brings back its uint8
index matrices and a little float32 metadata.  The host resamples those
to pixels (:func:`..render.tile.resample_indices`).

Routing: a bucket whose panels carry explicit finite bounds with
vmax > vmin runs the fused kernel (:func:`..ops.kernels.fused_quantize_lanes`),
both z scales.  Every other bucket runs the collapse kernel
(:func:`..ops.kernels.collapse_lanes`) and then the percentile-quantize
kernel (:func:`..ops.kernels.percentile_quantize_lanes`: bounds, index and
kept columns in one launch, with the percentile select switched off where
the bounds are explicit but degenerate); on the CPU that is the eager
:func:`..ops.spectrogram.quantize_matrix`.  ``Ep`` pads to a multiple of 8
on both routes (the kernels mask the column tail themselves).  A bucket
reads its cubes from the device-resident cube cache
(:mod:`.device_cache`: pinned uploads on a copy stream, each cube once),
and when the padded time axis is longer than the pixel width only the
rows the pixels sample are gathered on the device before the copy.

The render is split in two halves: :func:`enqueue_render_panels` queues
every bucket's uploads, launches and packed copy into pinned host memory
and returns a :class:`..render.drain.PendingRender`, whose ``wait()``
synchronises and unpacks; :func:`device_render_panels` is the two together.
Nothing in the enqueue half waits on the device: small lane arrays also
go up from pinned memory, because a copy from pageable memory
synchronises the stream.

Left out of the JAX pipeline on purpose: the packed-uint8 lane transfer,
the drain soft caps, the mesh and the resident result cache.  A rank
renders on its own card (one process per GPU, :mod:`..parallel.mesh`);
:data:`LAST_DISPATCH` says which.
"""

from __future__ import annotations

import numpy as np
import torch

from configurable_spectrograms_torch.ops.kernels import (
    collapse_lanes,
    fused_quantize_lanes,
    percentile_quantize_lanes,
)
from configurable_spectrograms_torch.ops.spectrogram import RenderSpec, _kept_energy_order
from configurable_spectrograms_torch.render.backend import render_backend
from configurable_spectrograms_torch.render.device_cache import count, stack_cubes
from configurable_spectrograms_torch.render.device_cache import upload_telemetry  # noqa: F401  (the JAX module's name)
from configurable_spectrograms_torch.render.drain import PendingBucket, PendingRender
from configurable_spectrograms_torch.render.panel import (
    PanelData,
    _bucket,
    _render_group_host,
)
from configurable_spectrograms_torch.render.tile import make_x_map, pixel_columns

#: The device the last device-backend render enqueued its buckets on
#: (``str(device)``, e.g. ``"cuda:1"``), as ``figure.LAST_DISPATCH`` records
#: the devices a bucket covered in the JAX package; ``None`` before one.
LAST_DISPATCH: dict[str, str | None] = {"device": None}


def _bucket_key(p: PanelData) -> tuple:
    T, A, E = p.cube.shape
    explicit = p.z_min is not None and p.z_max is not None
    fused = explicit and bool(np.isfinite(p.z_min) and np.isfinite(p.z_max) and p.z_max > p.z_min)
    return (
        _bucket(T, 256, 64),
        _bucket(A, 8, 8),
        _bucket(E, 8, 8),
        p.y_scale,
        p.z_scale,
        float(p.low_percentile),
        float(p.high_percentile),
        explicit,
        fused,
    )


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on *device*: through pinned memory on a card (no stream sync), as is on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _enqueue_group(panels: list[PanelData], idxs: list[int], key: tuple, tile_h: int, tile_w: int,
                   device: torch.device) -> PendingBucket:
    """One bucket: upload, run its route, gather rows, queue its one copy back."""
    Tp, Ap, Ep, y_scale, z_scale, lo_pct, hi_pct, explicit, fused = key
    n = len(idxs)
    # Deduplicate cubes within the bucket.
    slot_of: dict[int, int] = {}
    unique: list[np.ndarray] = []
    u_idx = np.zeros((n,), np.int32)
    for j, i in enumerate(idxs):
        c = panels[i].cube
        if id(c) not in slot_of:
            slot_of[id(c)] = len(unique)
            unique.append(c)
        u_idx[j] = slot_of[id(c)]

    masks = np.zeros((n, Ap), bool)
    energies = np.zeros((n, Ep), np.float32)
    e_valids = np.zeros((n, Ep), bool)
    zb_e_valids = np.zeros((n, Ep), bool)
    zb_full = np.zeros((n,), bool)
    t_valids = np.zeros((n,), np.int32)
    t_starts = np.zeros((n,), np.int32)
    t_counts = np.zeros((n,), np.int32)
    z_bounds = np.full((n, 2), np.nan, np.float32)
    for j, i in enumerate(idxs):
        p = panels[i]
        T, A, E = p.cube.shape
        masks[j, :A] = p.pitch_mask
        energies[j, :E] = p.energy
        e_valids[j, :E] = (p.energy >= p.y_min) & (p.energy <= p.y_max)
        t_valids[j] = T
        t_starts[j] = p.window.t_start
        t_counts[j] = p.window.t_count
        z_bounds[j] = (np.nan if p.z_min is None else p.z_min, np.nan if p.z_max is None else p.z_max)
        if p.bounds_energy_range is not None:
            b_lo, b_hi = p.bounds_energy_range
            zb_e_valids[j, :E] = (p.energy >= b_lo) & (p.energy <= b_hi)
            zb_full[j] = True
        else:
            zb_e_valids[j, :E] = e_valids[j, :E]

    # When the padded time axis exceeds the pixel width, gather one matrix
    # row per pixel column on the device: the copy then scales with pixels.
    gather_w = _bucket(tile_w, 256, 256) if Tp > _bucket(tile_w, 256, 256) else 0
    t_maps = np.zeros((n, max(gather_w, 1)), np.int64)
    if gather_w:
        for j, i in enumerate(idxs):
            cols, _ = pixel_columns(make_x_map(panels[i].window, tile_w), int(t_starts[j]),
                                    int(t_counts[j]), Tp, tile_w)
            t_maps[j, :tile_w] = cols

    count(dispatches=1, lanes=n)
    cubes = stack_cubes(unique, Tp, Ap, Ep, device)
    u_t, masks_t, ev_t, tv_t, ts_t, tc_t, zb_t, en_t, zbe_t, zbf_t, tm_t = (
        _to_device(a, device)
        for a in (u_idx, masks, e_valids, t_valids, t_starts, t_counts, z_bounds, energies, zb_e_valids,
                  zb_full, t_maps)
    )
    if fused:
        out = fused_quantize_lanes(cubes, u_t, masks_t, ev_t, tv_t, ts_t, tc_t, zb_t, z_scale)
        kept_pos, n_kept, flip, y0, y1 = _kept_energy_order(out["col_all_nan"], ev_t, en_t)
        q = {
            "idx": out["idx"], "kept_pos": kept_pos, "n_kept": n_kept, "flip": flip,
            "y0": y0, "y1": y1, "vmin": out["vmin"], "vmax": zb_t[:, 1],
            "empty": (n_kept == 0) | (tc_t <= 0),
        }
    else:
        m = collapse_lanes(cubes, u_t, masks_t, tv_t)
        spec = RenderSpec(8, 8, y_scale, z_scale, lo_pct, hi_pct)
        q = percentile_quantize_lanes(m, en_t, ev_t, tv_t, ts_t, tc_t, zb_t, spec,
                                      zb_e_valid=zbe_t, zb_full_time=zbf_t, skip_percentile=explicit)
    idx = q["idx"]
    if gather_w:
        idx = idx[torch.arange(n, device=device).view(n, 1), tm_t]
    meta = torch.cat(
        [
            torch.stack([q[k].to(torch.float32) for k in ("n_kept", "flip", "y0", "y1", "vmin", "vmax", "empty")], dim=1),
            q["kept_pos"].to(torch.float32),
        ],
        dim=1,
    )
    packed = torch.cat([idx.reshape(n, -1), meta.contiguous().view(torch.uint8)], dim=1)
    refs = [cubes, u_t, masks_t, ev_t, tv_t, ts_t, tc_t, zb_t, en_t, zbe_t, zbf_t, tm_t, packed]
    bucket = PendingBucket(idxs, Tp, Ep, y_scale, z_scale, gather_w, t_maps, packed, refs=refs)
    if device.type == "cuda":
        bucket.host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        bucket.host.copy_(packed, non_blocking=True)
        bucket.event = torch.cuda.Event()
        bucket.event.record(torch.cuda.current_stream(device))
    return bucket


def _groups(panels: list[PanelData]) -> dict[tuple, list[int]]:
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(panels):
        groups.setdefault(_bucket_key(p), []).append(i)
    return groups


def enqueue_render_panels(panels: list[PanelData], tile_h: int, tile_w: int) -> PendingRender:
    """Queue every bucket of *panels*; ``.wait()`` on the result returns the per-panel results in input order.

    With ``CST_RENDER_BACKEND=host`` every bucket renders in numpy here and
    the :class:`PendingRender` holds no device work.
    """
    results: list[dict | None] = [None] * len(panels)
    if not panels:
        return PendingRender(panels, tile_h, tile_w, results, [])
    groups = _groups(panels)
    if render_backend() == "host":
        for (_, _, _, y_scale, z_scale, lo_pct, hi_pct, _, _), idxs in groups.items():
            _render_group_host(panels, idxs, tile_h, tile_w, y_scale, z_scale, lo_pct, hi_pct, results)
        return PendingRender(panels, tile_h, tile_w, results, [])
    from configurable_spectrograms_torch.utils.timing import active_stage
    from configurable_spectrograms_torch.utils.torch_setup import get_device

    device = get_device()
    with active_stage("device_dispatch"):
        buckets = [_enqueue_group(panels, idxs, key, tile_h, tile_w, device) for key, idxs in groups.items()]
    LAST_DISPATCH["device"] = str(device)
    return PendingRender(panels, tile_h, tile_w, results, buckets)


def device_render_panels(panels: list[PanelData], tile_h: int, tile_w: int) -> list[dict]:
    """Rasterize many panels: one device program and one copy per bucket (enqueue, then wait).

    Returns per-panel results in input order (see
    :func:`..render.panel.build_panel_result`).
    """
    return enqueue_render_panels(panels, tile_h, tile_w).wait()
