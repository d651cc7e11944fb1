"""On-device random-chunk sampling from device-resident raw scenes: the
zero-precompute training input (``TrainConfig(input='sampler')``).

The port's own copy of the JAX package's ``train/device_sampler.py``.  Raw
scenes are copied to the device once; every step cuts a fresh chunk per
sample there, so there is no precompute pass and no chunk corpus on disk,
every visit of a scene sees a new chunk, and a step copies only a (B,)
scene-id array to the device.

Semantics are those of ``data/scannet/chunks.sample_random_chunk``: a
random centre point, a 1.5 x 1.5 m xy box with a 0.2 m context margin, up
to ``MAX_TRIES`` tries for a box whose candidates are >= 70 % labelled and
occupy >= 2 % of a 31 x 31 x 62 voxel grid, the last tried box with
candidates when no try passes (the whole stripe only when no try had any),
``npoints`` drawn with replacement, weight = class_weight[label] x
inside-the-inner-box.

Each scene is sorted once on the host by a scene-anchored voxel id whose
primary key is the x-cell (``scene_voxel_sort``), so a box's candidates lie
in one contiguous x-stripe of at most ``sub_len`` rows, and counting the
occupied voxels among them is one ``cummax`` (``occupancy='fast'``; the
bbox-fit grid with one sort is ``occupancy='exact'``).  Scenes share one
concatenated buffer with ``max_len`` rows of tail padding, so a stripe
``offset + start + [0, sub_len)`` never runs past the buffer.

Differences from the JAX sampler:

- Random numbers are an explicit input, ``draws = (centres (B, MAX_TRIES)
  int64 in [0, length), u (B, npoints) float32 in [0, 1))``, made from a
  ``torch.Generator`` by ``make_draws``.  Fed JAX's draws, a sampled chunk
  equals JAX's bit for bit, but for colors / 255 (correctly rounded here,
  a product with the reciprocal in XLA's: within 1 ulp).
- JAX's ``while_loop`` becomes one (B, MAX_TRIES, sub_len) pass over all
  tries, followed by a scan over the per-try verdicts that keeps what the
  loop would have kept (tries after the first valid one change nothing).
- XLA compiles a division by a constant into a product with the constant's
  float32 reciprocal; the stripe start and the occupancy fraction compute
  that product explicitly, so their verdicts equal JAX's on every input (a
  product is correctly rounded on the CPU and on CUDA alike).
- Everything runs as tensor ops on the scenes' device, with no host sync.

Under data parallelism each rank keeps its node's scene shard on its device
(``ResidentScenes(mesh=)``; the trainer shards the names with
``host_shard``), every rank of a node reads the node's global scene-id
stream, and a step takes its rows; ``make_draws`` and the rotation draw for
the global batch and keep the rank's rows (``parallel.mesh.local_rows``),
so on one node the ranks together take world size 1's step.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import (
    CHUNK_SIZE,
    CONTEXT_MARGIN,
    MAX_TRIES,
    MIN_LABELED_FRACTION,
    MIN_VOXEL_OCCUPANCY,
    OCCUPANCY_GRID,
)
from pointcloud_segmentation_attention_tpu_torch.data.wire import exact_div
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import data_parallel, local_rows
from pointcloud_segmentation_attention_tpu_torch.train import schedules, step_graph, steps
from pointcloud_segmentation_attention_tpu_torch.train.device_replay import (
    _augment_generator,
    rotate_batch_z,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils import profiler

_N_VOXELS = int(np.prod(OCCUPANCY_GRID))
_SENTINEL_VX = 2 ** 30


def scene_voxel_sort(points: np.ndarray, chunk_size: float = CHUNK_SIZE,
                     margin: float = CONTEXT_MARGIN
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side, once a scene: the sort order by scene-anchored voxel id,
    each sorted point's first index of its voxel run (in sorted order), and
    the sorted x-cells.  Cells are (chunk + 2*margin)/31 wide in xy and the
    scene's z extent / 62 high; the x-cell is the primary key."""
    lo = points.min(axis=0)
    cxy = (chunk_size + 2 * margin) / OCCUPANCY_GRID[0]
    cz = max(float(points[:, 2].max() - lo[2]), 1e-6) / OCCUPANCY_GRID[2]
    vx = np.floor((points[:, 0] - lo[0]) / cxy).astype(np.int64)
    vy = np.floor((points[:, 1] - lo[1]) / cxy).astype(np.int64)
    vz = np.minimum((points[:, 2] - lo[2]) / cz, OCCUPANCY_GRID[2] - 1).astype(np.int64)
    vid = (vx * (vy.max() + 1) + vy) * OCCUPANCY_GRID[2] + vz
    order = np.argsort(vid, kind="stable")
    sorted_vid = vid[order]
    new_run = np.empty(len(points), bool)
    new_run[0] = True
    np.not_equal(sorted_vid[1:], sorted_vid[:-1], out=new_run[1:])
    run_start_rel = np.maximum.accumulate(
        np.where(new_run, np.arange(len(points)), 0)).astype(np.int32)
    return order, run_start_rel, vx[order].astype(np.int32)


# x-cells a (chunk + 2*margin)-wide box can straddle: 31 cells of exactly
# that width, +1 for the grid phase, +1 so the exclusive upper bound is safe.
_STRIPE_CELLS = OCCUPANCY_GRID[0] + 2


def stripe_window_len(vx_sorted: np.ndarray) -> int:
    """The most points any chunk's x-stripe holds in this scene: the largest
    population of ``_STRIPE_CELLS`` consecutive x-cells."""
    counts = np.bincount(vx_sorted)
    prefix = np.concatenate([[0], np.cumsum(counts)])
    w = min(_STRIPE_CELLS, len(counts))
    return int((prefix[w:] - prefix[:-w]).max()) if len(prefix) > w else len(vx_sorted)


def check_budget(lengths, use_colors: bool, use_normals: bool,
                 budget_mb: Optional[float]) -> None:
    """Raise ``ValueError`` when the resident buffers of scenes of these
    lengths would exceed ``budget_mb``; needs only the lengths, so it runs
    before any scene body is loaded."""
    if budget_mb is None:
        return
    need = ResidentScenes.estimate_bytes(lengths, use_colors, use_normals)
    if need > budget_mb * 2 ** 20:
        raise ValueError(
            f"resident sampler corpus needs {need / 2**20:.0f} MB of device memory (and "
            f"host RAM to build it) > budget_mb={budget_mb:.0f} for {len(lengths)} scenes "
            "— raise sampler_budget_mb or fall back to a packed input mode")


class ResidentScenes:
    """Raw scenes, voxel-sorted and concatenated, copied to ``device`` once.

    ``points`` (R, 3) f32, ``labels`` (R,) int32, ``colors`` (R, 3) u8,
    ``normals`` (R, 3) f32, ``run_start`` (R,) int32, ``vx`` (R,) int32
    (tail padded with ``2**30``), ``x_mins`` (S,) f32, ``d_offsets`` /
    ``d_lengths`` (S,) int64 on the device; ``offsets`` / ``lengths`` (S,)
    int32 on the host.  R = total points + ``max_len``.  ``sub_len``: the
    largest x-stripe population rounded up to 1024, at most ``max_len``.
    ``mesh``: a rank's data-parallel mesh; the scenes (its node's shard) go
    to its device."""

    @staticmethod
    def estimate_bytes(lengths, use_colors: bool = True, use_normals: bool = True) -> int:
        """Device bytes of the buffers for scenes of these lengths: points
        f32x3 + labels i32 + run_start i32 + vx i32 [+ colors u8x3 + normals
        f32x3], each with ``max(lengths)`` rows of tail padding."""
        lengths = np.asarray(lengths, np.int64)
        rows = int(lengths.sum() + lengths.max())
        return rows * (12 + 4 + 4 + 4 + 3 * int(use_colors) + 12 * int(use_normals))

    def __init__(self, scenes: Sequence[Dict[str, np.ndarray]], *, device="cuda",
                 use_colors: bool = True, use_normals: bool = True,
                 chunk_size: float = CHUNK_SIZE, margin: float = CONTEXT_MARGIN,
                 budget_mb: Optional[float] = None, mesh=None):
        if not scenes:
            raise ValueError(
                "ResidentScenes got an empty scene list — input='sampler' needs at least "
                "one train scene")
        lengths = np.array([len(s["points"]) for s in scenes], np.int32)
        check_budget(lengths, use_colors, use_normals, budget_mb)
        self.device = mesh.device if mesh is not None else resolve(device)
        self.lengths = lengths
        self.offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
        self.max_len = int(lengths.max())
        self.use_colors = use_colors
        self.use_normals = use_normals
        self.chunk_size = chunk_size
        self.margin = margin

        orders, run_starts, vxs = zip(*(
            scene_voxel_sort(np.asarray(s["points"], np.float32), chunk_size, margin)
            for s in scenes))
        raw_sub = max(stripe_window_len(v) for v in vxs)
        self.sub_len = min(self.max_len, -(-raw_sub // 1024) * 1024)
        # A stripe starts at most ``length`` rows into its scene, so it ends
        # within the tail padding as long as sub_len <= max_len: no index
        # is ever clamped (a clamped start would read the next scene).
        assert self.sub_len <= self.max_len

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        def cat(key: str, dtype) -> torch.Tensor:
            parts = [np.asarray(s[key])[o] for s, o in zip(scenes, orders)]
            parts.append(np.zeros((self.max_len,) + parts[0].shape[1:], parts[0].dtype))
            return put(np.concatenate(parts).astype(dtype))

        self.points = cat("points", np.float32)
        self.labels = cat("labels", np.int32)
        self.colors = cat("colors", np.uint8) if use_colors else None
        self.normals = cat("normals", np.float32) if use_normals else None
        self.run_start = put(np.concatenate(list(run_starts)
                                            + [np.zeros(self.max_len, np.int32)]))
        self.vx = put(np.concatenate(list(vxs)
                                     + [np.full(self.max_len, _SENTINEL_VX, np.int32)]))
        self.x_mins = put(np.stack([np.asarray(s["points"], np.float32)[:, 0].min()
                                    for s in scenes]).astype(np.float32))
        self.d_offsets = put(self.offsets.astype(np.int64))
        self.d_lengths = put(lengths.astype(np.int64))


def _recip(d: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 reciprocal of ``d`` as a 0-dim tensor on ``like``'s
    device: what XLA multiplies by where the JAX sampler divides by ``d``."""
    r = np.float32(1.0) / np.float32(d)
    return torch.full((), float(r), dtype=torch.float32, device=like.device)


def _occupancy_fraction_fast(win_run_start: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Fraction of the grid's voxels occupied by the candidates of
    voxel-presorted windows (..., L), float32: a point counts iff it is the
    first candidate of its voxel run, i.e. the nearest candidate strictly
    before it lies before the run's start (``win_run_start``, relative to
    the window)."""
    iota = torch.arange(cand.shape[-1], dtype=torch.int32, device=cand.device)
    prev_incl = torch.cummax(torch.where(cand, iota, torch.full_like(iota, -1)), dim=-1).values
    prev_before = torch.cat([torch.full_like(prev_incl[..., :1], -1), prev_incl[..., :-1]],
                            dim=-1)
    count = (cand & (prev_before < win_run_start)).sum(dim=-1).to(torch.float32)
    return count * _recip(_N_VOXELS, count)


@functools.lru_cache(maxsize=None)
def _grid(device: torch.device) -> torch.Tensor:
    # Made once per device: a table built from a Python tuple each call
    # would be a synchronous host-to-device copy.
    return torch.tensor(OCCUPANCY_GRID, dtype=torch.float32, device=device)


def _occupancy_fraction_exact(pts: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Fraction of occupied voxels among the candidates of (..., L, 3)
    windows on the grid fitted to the candidates' bbox (the twin of
    ``chunks._voxel_occupancy``), non-candidates in a sentinel bin; one sort
    a window.  The A/B reference of the fast path."""
    c3 = cand[..., None]
    lo = torch.where(c3, pts, pts.new_full((), 1e30)).amin(dim=-2, keepdim=True)
    hi = torch.where(c3, pts, pts.new_full((), -1e30)).amax(dim=-2, keepdim=True)
    extent = torch.clamp_min(hi - lo, 1e-6)
    grid = _grid(pts.device)
    cell = torch.minimum((pts - lo) / extent * grid, grid - 1).to(torch.int32)
    flat = (cell[..., 0] * OCCUPANCY_GRID[1] + cell[..., 1]) * OCCUPANCY_GRID[2] + cell[..., 2]
    flat = torch.where(cand, flat.clamp(0, _N_VOXELS - 1),
                       torch.full_like(flat, _N_VOXELS))
    s = torch.sort(flat, dim=-1).values
    first_real = (s[..., 0] < _N_VOXELS).to(torch.float32)
    transitions = ((s[..., 1:] != s[..., :-1]) & (s[..., 1:] < _N_VOXELS)).sum(dim=-1)
    count = transitions.to(torch.float32) + first_real
    return count * _recip(_N_VOXELS, count)


def _stripe_rows(scenes: ResidentScenes, offsets: torch.Tensor, starts: torch.Tensor
                 ) -> torch.Tensor:
    """Buffer rows ``offset + start + [0, sub_len)`` of each stripe:
    offsets (B,), starts (B, ...) -> (B, ..., sub_len) int64."""
    base = offsets.reshape((-1,) + (1,) * (starts.dim() - 1)) + starts.long()
    return base[..., None] + torch.arange(scenes.sub_len, device=starts.device)


def _stripe_masks(xy: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor, margin: float):
    """(valid, cand) of stripes: xy (B, ..., L, 2), starts (B, ...), lo/hi
    (B, ..., 2).  valid: the row belongs to the scene; cand: valid and
    inside the box grown by the margin."""
    b_shape = (-1,) + (1,) * (starts.dim() - 1)
    pos = starts.long()[..., None] + torch.arange(xy.shape[-2], device=xy.device)
    valid = pos < lengths.reshape(b_shape)[..., None]
    lo_m, hi_m = (lo - margin)[..., None, :], (hi + margin)[..., None, :]
    cand = ((xy >= lo_m) & (xy <= hi_m)).all(dim=-1) & valid
    return valid, cand


def make_draws(scenes: ResidentScenes, scene_ids: torch.Tensor, npoints: int,
               generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random numbers of one ``sample_chunk_batch`` call, from
    ``generator`` (a generator of the scenes' device): centres (B,
    MAX_TRIES) int64 uniform in [0, length of the sample's scene), u (B,
    npoints) float32 in [0, 1).  Under a data-parallel mesh, ``scene_ids``
    are this rank's rows and the draws are the global batch's rows."""
    b = scene_ids.shape[0]
    dev = scenes.device
    lengths = scenes.d_lengths[scene_ids.to(dev).long()]
    raw = local_rows(lambda shape: torch.randint(1 << 62, shape, generator=generator,
                                                 device=dev), (b, MAX_TRIES))
    u = local_rows(lambda shape: torch.rand(shape, generator=generator, device=dev,
                                            dtype=torch.float32), (b, npoints))
    return raw % lengths[:, None], u


def sample_chunk_batch(scenes: ResidentScenes, scene_ids, draws, npoints: int,
                       class_weights=None, occupancy: str = "fast",
                       with_box: bool = False) -> Dict[str, torch.Tensor]:
    """(B,) scene ids + ``draws`` (see ``make_draws``) -> a training batch
    on the scenes' device: 'points' (B, npoints, 3) f32, 'labels' int32,
    'weights' f32 and, with colors or normals, 'features' (colors / 255,
    then normals); with ``with_box`` also 'chunk_lo', 'chunk_hi' (B, 2) (the
    kept box) and 'chunk_ok' (B,) (a try passed)."""
    if occupancy not in ("fast", "exact"):
        raise ValueError(f"occupancy must be 'fast' or 'exact', got {occupancy!r}")
    dev = scenes.device
    sid = torch.as_tensor(scene_ids).to(dev, non_blocking=True).long()
    centres, u = (d.to(dev, non_blocking=True) for d in draws)
    b = sid.shape[0]
    offsets, lengths, x_mins = scenes.d_offsets[sid], scenes.d_lengths[sid], scenes.x_mins[sid]
    margin = scenes.margin
    half = scenes.chunk_size / 2.0
    cxy = (scenes.chunk_size + 2 * margin) / OCCUPANCY_GRID[0]

    # Every try's box, and its stripe start: the first sorted row whose
    # x-cell can hold x >= lo_x - margin, searched in the scene's x-cells
    # (rows past the scene's length read as the sentinel).
    ci = centres.long().clamp(0, scenes.max_len - 1)
    centre = scenes.points[offsets[:, None] + ci][..., :2]          # (B, T, 2)
    lo, hi = centre - half, centre + half
    target = torch.floor((lo[..., 0] - margin - x_mins[:, None]) * _recip(cxy, lo))
    win = torch.arange(scenes.max_len, device=dev)
    win_vx = torch.where(win < lengths[:, None], scenes.vx[offsets[:, None] + win],
                         torch.full((), _SENTINEL_VX, dtype=torch.int32, device=dev))
    starts = torch.searchsorted(win_vx, target.to(torch.int32).contiguous(), right=False)

    # All tries at once on their stripes (B, T, sub_len).
    rows = _stripe_rows(scenes, offsets, starts)
    s_pts = scenes.points[rows]
    _, cand = _stripe_masks(s_pts[..., :2], starts, lengths, lo, hi, margin)
    n_cand = cand.sum(dim=-1)
    n_lab = (cand & (scenes.labels[rows] > 0)).sum(dim=-1)
    labeled = n_lab.to(torch.float32) / n_cand.clamp_min(1).to(torch.float32)
    if occupancy == "fast":
        occ = _occupancy_fraction_fast(scenes.run_start[rows] - starts[..., None].to(torch.int32),
                                       cand)
    else:
        occ = _occupancy_fraction_exact(s_pts, cand)
    has = n_cand > 0
    good = has & (labeled >= MIN_LABELED_FRACTION) & (occ >= MIN_VOXEL_OCCUPANCY)
    del rows, s_pts, cand

    # The loop's verdicts: try t runs iff no earlier try passed; a run try
    # with candidates becomes the kept box (so the first passing try, or
    # the last one with candidates); untried boxes change nothing.
    ran = (torch.cumsum(good.to(torch.int32), dim=-1) - good.to(torch.int32)) == 0
    taken = has & ran
    any_cand = taken.any(dim=-1)
    ok = good.any(dim=-1)
    t_idx = torch.arange(MAX_TRIES, device=dev)
    last = torch.where(taken, t_idx, torch.full_like(t_idx, -1)).amax(dim=-1)
    pick = last.clamp_min(0)[:, None]
    box_lo = torch.where(any_cand[:, None], lo.gather(1, pick[..., None].expand(b, 1, 2))[:, 0],
                         torch.zeros_like(lo[:, 0]))
    box_hi = torch.where(any_cand[:, None], hi.gather(1, pick[..., None].expand(b, 1, 2))[:, 0],
                         torch.zeros_like(hi[:, 0]))
    start = torch.where(any_cand, starts.gather(1, pick)[:, 0], torch.zeros_like(starts[:, 0]))

    # The final draw: npoints with replacement, uniform over the kept box's
    # candidates (over the whole stripe when no try had any).
    rows = _stripe_rows(scenes, offsets, start)                       # (B, sub_len)
    valid, cand = _stripe_masks(scenes.points[rows][..., :2], start, lengths, box_lo, box_hi,
                                margin)
    cand = torch.where(any_cand[:, None], cand, valid)
    cdf = torch.cumsum(cand.to(torch.float32), dim=-1)
    take = torch.searchsorted(cdf, (u * cdf[:, -1:]).contiguous(), right=False)
    take = take.clamp(0, scenes.sub_len - 1)
    picked = offsets[:, None] + start[:, None] + take                 # (B, npoints)
    points = scenes.points[picked]
    labels = scenes.labels[picked]
    xy = points[..., :2]
    in_box = ((xy >= box_lo[:, None]) & (xy <= box_hi[:, None])).all(dim=-1)
    inner = torch.where(any_cand[:, None], in_box & cand.gather(1, take),
                        valid.gather(1, take))
    out = {"points": points, "labels": labels,
           "weights": steps.make_sample_weights(labels, inner, class_weights)}
    parts = []
    if scenes.colors is not None:
        parts.append(exact_div(scenes.colors[picked].to(torch.float32), 255.0))
    if scenes.normals is not None:
        parts.append(scenes.normals[picked])
    if parts:
        out["features"] = torch.cat(parts, dim=-1)
    if with_box:
        out.update(chunk_lo=box_lo, chunk_hi=box_hi, chunk_ok=ok)
    return out


def _sampler_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The sampler's stream of one step, seeded from (seed, 1000, step),
    apart from the dropout (seed, step) and rotation (seed, 77, step)
    streams.  Its numbers are not JAX's."""
    mixed = np.random.SeedSequence((seed, 1000, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def make_sampling_train_step(scenes: ResidentScenes, npoints: int, *, class_weights=None,
                             occupancy: str = "fast", augment: bool = False, mesh=None,
                             **step_kwargs):
    """``step(state, scene_ids, seed=0, draws=None) -> (state, metrics)``:
    cut a fresh chunk per sample on the device and run ``seg_train_step``
    on them (the state is updated in place).  ``draws`` default to
    ``make_draws`` from a generator seeded by (seed, state.step).
    ``augment=True`` turns each chunk about z by a fresh angle
    (``rotate_batch_z``, seeded by (seed, 77, state.step)).  With a
    data-parallel ``mesh`` the step takes the global scene ids and runs on
    this rank's rows (``parallel.data_parallel``); explicit ``draws`` are
    then this rank's rows.  Where ``step_graph.eligible`` holds (one CUDA
    device, no remat, no augmentation) the step replays a CUDA graph of
    the cut, forward, backward and BN updates, equal to the eager step bit
    for bit (``train/step_graph.py``).  Under a profiler the step is the
    span ``train.step`` (counted in ``train.steps``), the chunks' cut
    ``train.sample`` within it (within the replay's ``train.graph_replay``
    on the graphed path, without the draws).  The step's ``graphed``
    attribute is its ``step_graph.GraphedStep`` once it has one."""
    remat = step_kwargs.get("remat", "none")

    def eager(state, scene_ids, seed, draws):
        dev = scenes.device
        with profiler.span("train.sample"):
            ids = torch.as_tensor(scene_ids).to(dev, non_blocking=True)
            if draws is None:
                draws = make_draws(scenes, ids, npoints,
                                   _sampler_generator(dev, seed, state.step))
            batch = sample_chunk_batch(scenes, ids, draws, npoints, class_weights,
                                       occupancy=occupancy)
            if augment:
                batch = rotate_batch_z(batch, scenes,
                                       _augment_generator(dev, seed, state.step))
        return steps.seg_train_step(state, batch, seed, **step_kwargs)

    def body(state, static, generator, bn_momentum):
        with profiler.span("train.sample"):
            batch = sample_chunk_batch(scenes, static["ids"], (static["centres"], static["u"]),
                                       npoints, class_weights, occupancy=occupancy)
        return steps.seg_gradient_step(state, batch, generator, bn_momentum,
                                       num_classes=step_kwargs.get("num_classes", 21))

    def step(state: TrainState, scene_ids, seed: int = 0, draws=None):
        with profiler.span("train.step", state.step):
            profiler.count("train.steps")
            dev = scenes.device
            if not step_graph.eligible(dev, mesh, remat, augment):
                return eager(state, scene_ids, seed, draws)
            if step.graphed is None:
                step.graphed = step_graph.GraphedStep(dev, body, step_kwargs.get(
                    "bn_schedule", schedules.scannet_bn_momentum))
            ids = torch.as_tensor(scene_ids).to(dev, non_blocking=True)
            if draws is None:
                draws = make_draws(scenes, ids, npoints,
                                   _sampler_generator(dev, seed, state.step))
            inputs = {"ids": ids, "centres": draws[0], "u": draws[1]}
            return step.graphed(state, inputs, seed, lambda: eager(state, ids, seed, draws))

    step.graphed = None
    return data_parallel(step, mesh)
