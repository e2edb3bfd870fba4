"""The pitch-collapse, fused-quantize and STFT-power kernels, and their plain versions.

Counterparts of ``configurable_spectrograms_tpu/ops/pallas_kernels.py``:

* :func:`collapse_lanes` replaces ``collapse_cube_pallas``
  (``_collapse_kernel``), batched over lanes so a whole render bucket or a
  whole extrema batch is one launch.  It is the production collapse of
  the port: the percentile (raw) render buckets and the extrema pre-pass
  both run on it.  The kernel groups the lanes by cube (:func:`lane_groups`
  states the rule) and reads each cube element once per group, adding it
  to every lane of the group that selects its pitch bin; the sums stay in
  index order, so it is bit-identical to :func:`collapse_lanes_plain`.
* :func:`fused_quantize_lanes` replaces ``fused_quantize_pallas``
  (``_fused_quantize_kernel``): collapse + explicit-bounds colormap index
  in two launches (see ``csrc/fused_quantize.cu``).  The first runs the
  same grouped collapse as :func:`collapse_lanes` and folds one minimum per
  lane and ``col_any`` per (lane, column); the second quantizes.  It
  carries the given-extrema render buckets.
* :func:`stft_power` replaces ``stft_power_pallas`` (``_stft_power_kernel``):
  the windowed-DFT power spectrogram of ``ops/stft.py``'s ``"pallas"``
  method, read straight from the framed signal, with the products on the
  tensor cores in 3xTF32 (see ``csrc/stft_power.cu``).  Not bit-identical
  to :func:`stft_power_plain`: on the card it is held to the plain
  version's tolerance, and its error against a float64 product to within
  4x the plain version's.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
launches its CUDA kernel for tensors on a CUDA device -- or raises.  A
launch runs with its tensors' device made current
(``torch.cuda.device``): CUDA's current device belongs to the host thread,
and a worker thread starts on device 0 whichever card its rank owns.
Nothing falls back from the kernel to the plain version.  A launch adds one
to :data:`LAUNCHES`, so a run can show that its main path went through the
kernels.

Lane layout shared by both: ``cubes`` (U, T, A, E) float32, ``u_idx`` (L,)
int32 picks each lane's cube, ``masks`` (L, A) bool its pitch bins,
``t_valid`` (L,) int32 its real rows (rows at or past it collapse to NaN).
"""

from __future__ import annotations

import threading

import torch

#: Launch counts of the CUDA kernels (one per wrapper call that launched).
LAUNCHES: dict[str, int] = {"collapse": 0, "fused_quantize": 0, "stft_power": 0}
_LAUNCHES_LOCK = threading.Lock()  # the batch driver launches from several threads

_BIG = 3.0e38  # the fill of the safe-floor minimum, as in ops/spectrogram._analyze_matrix


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


#: Lanes the collapse kernels serve from one read of their cube (``CST_GROUP``
#: in ``csrc/collapse_common.cuh``).
COLLAPSE_GROUP = 8


def lane_groups(u_idx, group: int = COLLAPSE_GROUP) -> list[list[int]]:
    """The collapse kernels' lane groups: lists of lane indices, one cube each.

    The lanes of each cube in index order, cut into runs of at most
    *group*; groups are listed by their first lane.  The kernels (collapse
    and fused) find the same groups themselves from ``u_idx``
    (``csrc/collapse_common.cuh``), so a wrapper launches once with no host
    work; this states the rule, and gives the bytes a launch reads (one
    pass over each group's cube).
    """
    runs: dict[int, list[list[int]]] = {}
    out = []
    for lane, u in enumerate(torch.as_tensor(u_idx).tolist()):
        cube = runs.setdefault(u, [])
        if not cube or len(cube[-1]) == group:
            cube.append([])
            out.append(cube[-1])
        cube[-1].append(lane)
    return out


_TF32_HALF = 0x1000  # half a unit in the last of TF32's 10 mantissa bits
_TF32_MASK = -0x2000  # 0xFFFFE000: sign, exponent and 10 mantissa bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + _TF32_HALF) & _TF32_MASK).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x = hi + lo`` to about 2^-22 relative, each part with at most 11 significant bits."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


#: Padding of the prepared bases: bins to the kernel's narrowest bin tile,
#: samples to one shared-memory stage (``csrc/stft_power.cu``).
_STFT_BIN_PAD, _STFT_SAMPLE_PAD = 16, 16


def stft_bases_t(cos_b: torch.Tensor, sin_b: torch.Tensor) -> torch.Tensor:
    """(L, K) cos and sin bases -> (4, Kp, Lp) scratch: cos hi, cos lo, sin hi, sin lo.

    Transposed to bins x samples (the tensor cores take TF32 operands
    K-major only), split by :func:`tf32_split`, zero-padded to
    ``Kp = 16 * ceil(K / 16)`` and ``Lp = 16 * ceil(L / 16)``.
    """
    L, K = cos_b.shape
    Kp = -(-K // _STFT_BIN_PAD) * _STFT_BIN_PAD
    Lp = -(-L // _STFT_SAMPLE_PAD) * _STFT_SAMPLE_PAD
    bt = torch.zeros((4, Kp, Lp), dtype=torch.float32, device=cos_b.device)
    for i, part in enumerate((*tf32_split(cos_b), *tf32_split(sin_b))):
        bt[i, :K, :L] = part.t()
    return bt


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def collapse_lanes_plain(cubes: torch.Tensor, u_idx: torch.Tensor, masks: torch.Tensor,
                         t_valid: torch.Tensor) -> torch.Tensor:
    """Masked nansum over pitch, one (T, E) matrix per lane.

    An explicit loop over the pitch axis IN INDEX ORDER, not
    ``torch.sum(dim=...)``: torch's CPU reduction does not add the slices
    in order, and the host collapse and the extrema pool (numpy) do, bit
    for bit.  Unselected and NaN entries add 0.0.
    """
    _, T, A, E = cubes.shape
    L = u_idx.shape[0]
    idx = u_idx.long()
    acc = torch.zeros((L, T, E), dtype=torch.float32, device=cubes.device)
    for a in range(A):
        v = cubes[idx, :, a, :]
        keep = masks[:, a].view(L, 1, 1) & ~torch.isnan(v)
        acc += torch.where(keep, v, torch.zeros((), dtype=torch.float32, device=v.device))
    rows = torch.arange(T, device=cubes.device).view(1, T, 1) < t_valid.view(L, 1, 1)
    return torch.where(rows, acc, torch.full((), float("nan"), device=cubes.device))


def fused_quantize_lanes_plain(cubes, u_idx, masks, e_valid, t_valid, t_start, t_count,
                               z_bounds, z_scale: str = "log") -> dict[str, torch.Tensor]:
    """Collapse + explicit-bounds quantize (the math of ``_fused_quantize_kernel``).

    Preconditions as in the JAX kernel: ``z_bounds`` (L, 2) finite with
    vmax > vmin.  Returns ``idx`` (L, T, E) uint8, ``vmin`` (L,) float32
    (the safe-floored bound actually used) and ``col_all_nan`` (L, E) bool.
    """
    c = collapse_lanes_plain(cubes, u_idx, masks, t_valid)
    L, T, E = c.shape
    dev = c.device
    rows = torch.arange(T, device=dev).view(1, T)
    in_file = rows < t_valid.view(L, 1)
    col_any = (~torch.isnan(c) & in_file.unsqueeze(-1)).any(dim=1)
    in_window = in_file & (rows >= t_start.view(L, 1)) & (rows < (t_start + t_count).view(L, 1))
    fp = torch.isfinite(c) & (c > 0) & in_window.unsqueeze(-1) & e_valid.view(L, 1, E)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    # The rule of _analyze_matrix: whether a finite positive cell exists is
    # its own test (a finite value at or above _BIG is one).
    safe_vmin = torch.where(fp.any(dim=(1, 2)), torch.where(fp, c, big).amin(dim=(1, 2)),
                            torch.tensor(1e-10, dtype=torch.float32, device=dev))
    vmin = z_bounds[:, 0].float()
    vmax = z_bounds[:, 1].float()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    if z_scale == "log":
        vmin = torch.maximum(torch.maximum(vmin, safe_vmin), torch.tensor(1e-10, dtype=torch.float32, device=dev))
        v3 = vmin.view(L, 1, 1)
        work = torch.where(~torch.isfinite(c) | (c <= 0), v3, c)
        log_vmin = torch.log10(vmin)
        log_span = torch.log10(vmax) - log_vmin
        denom = torch.where(log_span == 0, one, log_span).view(L, 1, 1)
        ramp = (torch.log10(torch.clamp_min(work, 1e-37)) - log_vmin.view(L, 1, 1)) / denom
    else:
        v3, w3 = vmin.view(L, 1, 1), vmax.view(L, 1, 1)
        work = torch.where(torch.isnan(c), v3, c)
        work = torch.where(work == float("-inf"), v3, work)
        work = torch.where(work == float("inf"), w3, work)
        span = vmax - vmin
        ramp = (work - v3) / torch.where(span == 0, one, span).view(L, 1, 1)
    norm = torch.where((vmin == vmax).view(L, 1, 1), zero, ramp)
    norm = torch.where(torch.isnan(norm), zero, norm)
    idx = torch.clamp(torch.floor(norm * 256.0), 0.0, 255.0).to(torch.uint8)
    return {"idx": idx, "vmin": vmin, "col_all_nan": ~col_any}


def stft_power_plain(frames: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor) -> torch.Tensor:
    """``(frames @ cos_b)^2 + (frames @ sin_b)^2`` in float32 (the math of ``_stft_power_kernel``).

    Full float32 products: :func:`..utils.torch_setup.get_device` turns
    TF32 off for CUDA matmuls.
    """
    re = frames @ cos_b
    im = frames @ sin_b
    return re * re + im * im


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_lanes(cubes, u_idx, masks, t_valid) -> tuple[int, int, int, int, int]:
    if cubes.dim() != 4 or cubes.dtype != torch.float32:
        raise ValueError(f"cubes must be (U, T, A, E) float32, got {tuple(cubes.shape)} {cubes.dtype}")
    U, T, A, E = cubes.shape
    L = u_idx.shape[0]
    if u_idx.dtype != torch.int32 or u_idx.dim() != 1:
        raise ValueError("u_idx must be (L,) int32")
    if masks.dtype != torch.bool or tuple(masks.shape) != (L, A):
        raise ValueError(f"masks must be ({L}, {A}) bool, got {tuple(masks.shape)} {masks.dtype}")
    if t_valid.dtype != torch.int32 or tuple(t_valid.shape) != (L,):
        raise ValueError("t_valid must be (L,) int32")
    return U, T, A, E, L


def _cuda_args(*tensors: torch.Tensor) -> list[int]:
    """Device pointers, after checking every tensor is contiguous on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all kernel inputs must be on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return [t.data_ptr() for t in tensors]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def collapse_lanes(cubes: torch.Tensor, u_idx: torch.Tensor, masks: torch.Tensor,
                   t_valid: torch.Tensor) -> torch.Tensor:
    """(U, T, A, E) cubes -> (L, T, E) masked nansum per lane (see module doc)."""
    U, T, A, E, L = _check_lanes(cubes, u_idx, masks, t_valid)
    if cubes.device.type == "cpu":
        return collapse_lanes_plain(cubes, u_idx, masks, t_valid)
    if cubes.device.type != "cuda":
        raise ValueError(f"collapse_lanes runs on cpu or cuda tensors, got {cubes.device}")
    from configurable_spectrograms_torch.ops._build import load_library

    lib = load_library()
    out = torch.empty((L, T, E), dtype=torch.float32, device=cubes.device)
    if L == 0:
        return out
    ptrs = _cuda_args(cubes, u_idx, masks, t_valid, out)
    with torch.cuda.device(cubes.device):
        stream = torch.cuda.current_stream(cubes.device).cuda_stream
        _raise_on(lib.cst_collapse(*ptrs, L, T, A, E, stream), "cst_collapse")
    _count_launch("collapse")
    return out


def fused_quantize_lanes(cubes, u_idx, masks, e_valid, t_valid, t_start, t_count, z_bounds,
                         z_scale: str = "log") -> dict[str, torch.Tensor]:
    """Collapse + explicit-bounds quantize per lane (see :func:`fused_quantize_lanes_plain`)."""
    U, T, A, E, L = _check_lanes(cubes, u_idx, masks, t_valid)
    if z_scale not in ("log", "linear"):
        raise ValueError(f"z_scale must be 'log' or 'linear', got {z_scale!r}")
    if e_valid.dtype != torch.bool or tuple(e_valid.shape) != (L, E):
        raise ValueError(f"e_valid must be ({L}, {E}) bool")
    for name, t in (("t_start", t_start), ("t_count", t_count)):
        if t.dtype != torch.int32 or tuple(t.shape) != (L,):
            raise ValueError(f"{name} must be (L,) int32")
    if z_bounds.dtype != torch.float32 or tuple(z_bounds.shape) != (L, 2):
        raise ValueError("z_bounds must be (L, 2) float32")
    if cubes.device.type == "cpu":
        return fused_quantize_lanes_plain(cubes, u_idx, masks, e_valid, t_valid, t_start,
                                          t_count, z_bounds, z_scale)
    if cubes.device.type != "cuda":
        raise ValueError(f"fused_quantize_lanes runs on cpu or cuda tensors, got {cubes.device}")
    work, out = fused_buffers(L, T, E, cubes.device)
    if L == 0:
        return out
    fused_launch((cubes, u_idx, masks, e_valid, t_valid, t_start, t_count, z_bounds), z_scale, work, out,
                 FUSED_BOTH)
    _count_launch("fused_quantize")
    return out


#: ``phases`` of ``cst_fused_quantize``: launch 1 (collapse + statistics), launch 2 (quantize), both.
FUSED_STATS, FUSED_MAP, FUSED_BOTH = 1, 2, 3


def fused_buffers(L: int, T: int, E: int, device) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The fused kernel's scratch and outputs: four allocations and no fills.

    ``work`` (float32) holds the collapsed (L, T, E) matrices, then
    ``col_any`` (L, E) int32, the lane minima (L,) as uint32 bits and the
    lanes' any-positive flags (L,) int32, which the kernel clears itself.  The outputs: ``idx`` (L, T, E) uint8, ``vmin``
    (L,) float32, ``col_all_nan`` (L, E) bool.
    """
    work = torch.empty((L * (T * E + E + 2),), dtype=torch.float32, device=device)
    out = {
        "idx": torch.empty((L, T, E), dtype=torch.uint8, device=device),
        "vmin": torch.empty((L,), dtype=torch.float32, device=device),
        "col_all_nan": torch.empty((L, E), dtype=torch.bool, device=device),
    }
    return work, out


def fused_launch(args: tuple, z_scale: str, work: torch.Tensor, out: dict[str, torch.Tensor],
                 phases: int) -> None:
    """Run ``cst_fused_quantize`` on the checked inputs into :func:`fused_buffers`' tensors (made on their device).

    Counts no launch: :func:`fused_quantize_lanes` does, and a caller
    timing the two launches apart passes ``phases`` 1 or 2.
    """
    from configurable_spectrograms_torch.ops._build import load_library

    cubes = args[0]
    _, T, A, E = cubes.shape
    L = args[1].shape[0]
    lte, le = L * T * E, L * E
    base = work.data_ptr()  # collapsed, then col_any, the lane minima, the lanes' any-positive flags
    lib = load_library()
    with torch.cuda.device(cubes.device):
        err = lib.cst_fused_quantize(
            *_cuda_args(*args), 1 if z_scale == "log" else 0, base, base + 4 * lte, base + 4 * (lte + le),
            base + 4 * (lte + le + L), out["idx"].data_ptr(), out["vmin"].data_ptr(),
            out["col_all_nan"].data_ptr(), L, T, A, E, phases,
            torch.cuda.current_stream(cubes.device).cuda_stream)
    _raise_on(err, "cst_fused_quantize")


def stft_power(frames: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor) -> torch.Tensor:
    """(F, L) frames x window-folded bases (L, K) -> (F, K) float32 power.

    ``frames`` may be any (F, L) float32 view with unit inner stride --
    ``signal.unfold(0, L, hop)`` is read in place, row stride ``hop``, with
    no (F, L) copy; any hop and L run.  ``cos_b`` / ``sin_b`` are contiguous
    (L, K) float32.  On a card the products run in 3xTF32 on the tensor
    cores, from bases this call prepares with :func:`stft_bases_t`
    (4 x K x L floats of scratch): the result is not bit-identical to
    :func:`stft_power_plain`, but within its tolerance, with an error
    against a float64 product within 4x the plain version's.
    """
    if frames.dim() != 2 or frames.dtype != torch.float32:
        raise ValueError(f"frames must be (F, L) float32, got {tuple(frames.shape)} {frames.dtype}")
    F, L = frames.shape
    if frames.stride(1) != 1:
        raise ValueError(f"frames must have unit inner stride, got strides {frames.stride()}")
    for name, b in (("cos_b", cos_b), ("sin_b", sin_b)):
        if b.dtype != torch.float32 or b.dim() != 2 or b.shape[0] != L or b.shape != cos_b.shape:
            raise ValueError(f"{name} must be ({L}, K) float32 like cos_b, got {tuple(b.shape)} {b.dtype}")
    K = cos_b.shape[1]
    if frames.device.type == "cpu":
        return stft_power_plain(frames, cos_b, sin_b)
    if frames.device.type != "cuda":
        raise ValueError(f"stft_power runs on cpu or cuda tensors, got {frames.device}")
    from configurable_spectrograms_torch.ops._build import load_library

    lib = load_library()
    out = torch.empty((F, K), dtype=torch.float32, device=frames.device)
    if F == 0:
        return out
    _cuda_args(out, cos_b, sin_b)  # one device: the frames'
    bt = stft_bases_t(cos_b, sin_b)
    with torch.cuda.device(frames.device):  # the kernel's shared-memory attribute is set on the current device
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = lib.cst_stft_power(frames.data_ptr(), frames.stride(0), F, L, bt.data_ptr(), K, bt.shape[1],
                                 bt.shape[2], out.data_ptr(), stream)
    _raise_on(err, "cst_stft_power")
    _count_launch("stft_power")
    return out
