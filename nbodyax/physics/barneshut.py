"""Approximate hierarchical gravity: Barnes-Hut/FMM-style far field +
exact grid-neighbor near field (``forceModel=bh``).

Beyond-reference capability: the reference (and our default ``exact`` model)
is O(N^2) per step; this model is O(N * levels).

- **Far field**: bodies are binned into a complete quadtree (2-D) or octree
  (3-D — the model is dimension-generic) of dense per-level mass/moment grids
  over the *adaptive* bounding box of the live bodies (finest side 2^levels;
  coarsening is 2^dim-child sum-pooling with parallel-axis moment shifts —
  pure XLA scatter/reshape, no pointer chasing). The classic FMM
  *interaction list* — children of the parent cell's ring-w neighborhood
  that are not within ring w of the cell itself — is covered exactly once
  across levels (telescoping). Two engines evaluate it (``bhFar``):

  * ``fmm`` (default): a true uniform-grid FMM. Per level, every cell
    accumulates a degree-3 LOCAL force expansion from its list via a
    dense stencil (every list offset is a compile-time constant, so the
    "gather" of a level's windows is a static slice of the padded grid
    times a tiny per-offset coefficient matrix — zero gather ops);
    expansions chain down the tree (L2L) and evaluate at each body's
    offset (L2P, the far field's only gather, one row per body). Because
    the local expansion converges slowly for the nearest list cells, the
    lists run at ring w+1 and the leftover finest-level annulus shell
    (w < |delta|_inf <= w+1) is evaluated with exact targets from sliced
    cell aggregates (_annulus_force_cells). Measured accuracy at
    ring=1/order=2: ~0.7% max relative force error — slightly better than
    ``direct`` — at a small fraction of its cost.
  * ``direct``: per-cell window gathers with exact target positions
    (ring=1 gives ~1e-2 relative force error, ring=2 ~1e-3).
- **Near field**: bodies sorted by finest-level cell id; each body interacts
  *exactly* — identical per-pair semantics to physics/pairwise.py, collision
  channels included — with its grid-neighbor bodies, capped by
  ``bhNeighborK``. Two engines (``bhNear``, auto-selected per scene):

  * ``rows``: up to K partners per (2*ring+1) neighbor-cell window ROW
    (the row's cells are contiguous in sorted order, so a row is one
    gather window; a crowded cell can use its row neighbors' unused
    slots). Tight caps, fastest on near-uniform scenes.
  * ``slots``: up to K partners per window CELL, sliced from a padded
    per-cell slot grid (zero window gathers). Absorbs clustering the
    shared row cap cannot — a galaxy core runs overflow-free at the
    uniform-density grid instead of forcing refinement.

Because the near field carries the full collision semantics, every collision
mode (reference / momentum / elastic) composes with this model unchanged.
Documented approximations:
1. overlaps spanning beyond the near window (radius sum > ring * cell size)
   are missed — fine while radii stay below the cell size;
2. window rows (``bhNear=rows``) or cells (``bhNear=slots``) holding more
   than K bodies drop the excess from near-field lists (``overflow_count``
   reports how many — the driver logs it as ``bh_overflow``; raise
   ``bhNeighborK`` or ``bhLevels`` if it is nonzero);
3. the monopole far field is not exactly antisymmetric (body A's pull from
   B's cell aggregate differs from B's pull from A's), so total momentum
   drifts at the far-field error level over long runs — standard for tree
   codes; use ``forceModel=exact`` where strict momentum conservation
   matters.

Dead bodies (mass 0) go to an out-of-grid bucket: they occupy no near-field
slots and contribute nothing to the aggregates.
"""

from __future__ import annotations

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nbodyax.physics.pairwise import (PairAccumulators, combine_accumulators,
                                      empty_accumulators)

__all__ = ["bh_accumulators", "bh_cellrange_accumulators",
           "auto_levels", "auto_neighbor_k", "pick_levels",
           "overflow_count", "bh_health", "slot_cap", "needed_neighbor_k"]

# np (not jnp) scalar: a module-level jnp value would initialize the JAX
# backend at import time, which breaks multi-host bring-up (jax.distributed
# must initialize first) — same convention as step.GRAV_CONSTANT
_NEG_INF = np.float32(-np.inf)


def auto_levels(n: int, target_occupancy: int = 0,
                max_levels: int = 10, dim: int = 2) -> int:
    """Finest level so average occupancy ~= target (grid side 2^levels,
    2^(dim*levels) cells: a quadtree in 2-D, an octree in 3-D).

    Why occupancy 16: the near field is CAP-bound (it gathers bhNeighborK
    rows per window regardless of occupancy, so coarser cells are nearly
    free until row occupancy approaches K), while each extra level costs a
    full interaction-list gather sweep — and the finest level's is the most
    expensive (largest cell table, worst locality). The target was swept on
    an earlier accelerator and is not yet re-measured on the GPU. 3-D levels
    are capped so the finest dense grid stays well under the device-memory
    budget (2^(3*7) = 2M cells)."""
    if dim == 3:
        max_levels = min(max_levels, 7)
    if not target_occupancy:
        # 2-D: 16. 3-D: 32 — the octree ceil overshoots hard (ceil log8
        # of the occupancy-16 cell count lands at occupancy ~4, 8x slot
        # padding and 8x more far-stencil cells). Neither target is yet
        # measured on the GPU (bench/bh_profile re-sweeps them)
        target_occupancy = 32 if dim == 3 else 16
    cells = max(4, n // max(1, target_occupancy))
    return max(2, min(max_levels, math.ceil(math.log(cells, 2 ** dim))))


def auto_neighbor_k(n: int, levels: int, ring: int = 1,
                    dim: int = 2, near: str = "rows") -> int:
    """Near-field partner cap matched to the grid, per engine:

    - ``near="rows"``: K caps a whole window ROW of (2*ring+1) cells —
      ~1.33x the average row population, floored at the occupancy-16
      default of 64. Rows aggregate over cells, so the
      Poisson tail is relatively tight and 1.33x covers it.
    - ``near="slots"``: k caps the partner slots PER CELL (windows slice k
      contiguous slot rows per neighbor cell) — ~2.5x the average cell
      occupancy (single-cell Poisson tails are fatter; 2.5x measured
      overflow-free on both the uniform and galaxy N=1M scenes), floor 40.

    Both multiples of 8."""
    occ = max(1, -(-n // (1 << (dim * levels))))
    if near == "slots":
        want = occ * 5 // 2
        return int(max(40, 8 * -(-want // 8)))
    want = (2 * ring + 1) * occ * 4 // 3
    return int(max(64, 8 * -(-want // 8)))


# Rows/slots crossover on UNIFORM scenes (interleaved A/B,
# ``python -m bench.near_ab``, auto knobs): the rows engine's per-row
# window gathers scale worse with table size than the slot grid's
# contiguous slices. Above this count auto prefers slots even when rows
# wouldn't overflow. Set on an earlier accelerator; not yet re-measured on
# the GPU.
_SLOTS_PREFERRED_N = 1_500_000


def pick_levels(pos, mass, *, neighbor_k: int = 0, ring: int = 1,
                max_levels: int = 10, tolerance: float = 0.01,
                near: str = "auto", levels: int = 0) -> tuple:
    """Density-aware finest-level, near-engine, partner-cap AND
    completion-budget choice from an actual state. Returns
    ``(levels, near, k, comp_cap)`` with ``near`` resolved to "rows" or
    "slots", ``k`` a COUNT-AWARE exact partner cap (auto mode) or the
    pinned ``neighbor_k``, and ``comp_cap`` a count-aware completion
    budget sized to the measured completion population — widened past
    the default ~n/16 when that would drop bodies, SHRUNK below it when
    the population is small enough that the default's worst-case static
    list would dominate the step (0 when the 1024 mid-tier covers it).

    ``auto_levels`` assumes near-uniform density; clustered scenes (galaxy
    cores) can overflow the near-field partner cap at that occupancy. This
    probes ``overflow_count`` on the given state and escalates until the
    overflow fraction is within ``tolerance``: with ``near="auto"`` it
    first tries the "rows" engine at the uniform-density level (fastest on
    near-uniform scenes below ``_SLOTS_PREFERRED_N`` bodies; above that the
    order flips), then the other engine at the same level (per-cell caps
    absorb clustering the row cap can't — the N=1M galaxy runs
    overflow-free WITHOUT refining), and only then refines the grid. The
    default 1% tolerance keeps truncation within the model's ring=1
    far-field accuracy class — but only as the ENGINE/LEVEL selection
    criterion.

    The returned ``k`` then makes the near field EXACT: with auto K
    (``neighbor_k=0``) the heuristic cap is raised to the measured per-cell
    (slots) / per-window-row (rows) maximum occupancy, so zero bodies are
    invisible as partners — the reference evaluates the collision overlap
    test for every pair unconditionally (nbody.cu:196-226), and truncating
    collisions is a binary physics error the 1% force tolerance does not
    license. When the needed cap is disproportionate (>4x the heuristic — a
    pathologically crowded cell) or the completion budget still drops
    bodies, the grid refines instead; at the level cap any residual
    completion drop is covered by widening ``comp_cap`` to the measured
    completion-pass population (+12.5% drift slack, 1024-tiered), so even
    a scene whose densest cell out-crowds the finest grid keeps exact
    near-field physics — only the 1024 partner-slot ceiling itself can
    leave residual overflow (and the driver's logged ``bh_overflow``
    reports it). The driver calls this once at startup when ``bhLevels=0``;
    bhAdapt re-widens from the same probe on later density drift.

    A nonzero ``levels`` pins the grid (no refinement): only the engine and
    cap are chosen, probed at that level."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    lv = levels or auto_levels(n, max_levels=max_levels, dim=dim)
    cap = lv if levels else (min(max_levels, 7) if dim == 3 else max_levels)

    probed = {}  # each (level, engine) probe is a device round-trip

    def ov_at(lv, eng):
        if (lv, eng) not in probed:
            k = neighbor_k or auto_neighbor_k(n, lv, ring, dim, eng)
            probed[lv, eng] = int(overflow_count(
                pos, mass, levels=lv, neighbor_k=k, ring=ring, near=eng))
        return probed[lv, eng]

    def exact_k(lv, eng):
        """Count-aware caps: (resolved k, still-dropped completion bodies,
        heuristic k, completion-pass population)."""
        k_auto = auto_neighbor_k(n, lv, ring, dim, eng)
        k_need, dropped, i_over = (int(v) for v in needed_neighbor_k(
            pos, mass, levels=lv, ring=ring, near=eng))
        return max(k_auto, 8 * -(-k_need // 8)), dropped, k_auto, i_over

    if near == "auto":
        order = (("slots", "rows") if n >= _SLOTS_PREFERRED_N
                 else ("rows", "slots"))
        for eng in order:
            if ov_at(lv, eng) <= n * tolerance:
                near = eng
                break
        else:
            near = "slots"
    while lv < cap and ov_at(lv, near) > n * tolerance:
        lv += 1
    if neighbor_k:
        return lv, near, neighbor_k, 0
    while True:
        k, dropped, k_auto, i_over = exact_k(lv, near)
        if lv >= cap or (k <= min(1024, 4 * k_auto) and dropped == 0):
            break
        lv += 1
    # Size the static completion budget to the measured population
    # (+12.5% density-drift slack, rounded to the 1024 tier _tiered
    # budgets use). Two cases:
    #   dropped > 0 — residual drop at the level cap: WIDEN past the
    #     default ~n/16 budget so zero bodies lose their near field;
    #   dropped == 0 but the population exceeds the 1024 mid-tier —
    #     SHRINK below the default: _tiered would otherwise run the full
    #     ~n/16 worst-case list for a few thousand real entries (the 4M
    #     galaxy ran its near+annulus completion over 262144 slots for
    #     3166 overflow bodies, most of its step).
    # Populations within the mid-tier keep comp=0 (the tier already
    # skips the cost; a nonzero cap would change nothing but the cfg).
    # bhAdapt re-widens from the same probe if density drift later
    # pushes the population past this budget.
    comp = 0
    pad = min(n, 1024 * -(-(i_over + i_over // 8) // 1024))
    if dropped or _COMP_TIER < pad < _completion_cap(n):
        comp = pad
    return lv, near, min(1024, k), comp


def _extent(pos, alive):
    """Adaptive bounding box of live bodies (traced scalars; shapes static).
    Returns (mins, spans): two length-D tuples, D = pos.shape[-1]."""
    big = jnp.float32(3e38)
    mins, spans = [], []
    for d in range(pos.shape[-1]):
        lo = jnp.min(jnp.where(alive, pos[:, d], big))
        hi = jnp.max(jnp.where(alive, pos[:, d], -big))
        mins.append(lo)
        spans.append(jnp.maximum(hi - lo, 1e-3) * 1.0001)
    return tuple(mins), tuple(spans)


def _cells(pos, ext, g):
    """Per-axis cell indices at grid side g: a length-D tuple of i32[N]."""
    mins, spans = ext
    return tuple(
        (jnp.clip((pos[:, d] - mins[d]) / spans[d], 0.0, 1.0 - 1e-7)
         * g).astype(jnp.int32)
        for d in range(pos.shape[-1]))


def _flatten_cells(cs, g):
    """Row-major flat cell id from per-axis indices (x fastest: adjacent x
    cells are adjacent flat ids — the near field's row-window contiguity)."""
    flat = cs[-1]
    for c in reversed(cs[:-1]):
        flat = flat * g + c
    return flat


def _cell_sizes(ext, g):
    mins, spans = ext
    return mins, tuple(s / g for s in spans)


def _moment_pairs(dim):
    """Index pairs (a <= b) of the symmetric second-moment tensor, in the
    channel order the grids store them."""
    return [(a, b) for a in range(dim) for b in range(a, dim)]


def _pool(a, s, dim):
    """Sum-pool 2^dim children into parents on a flat row-major grid of side
    s (x fastest — pooling pairs each axis, so axis order is irrelevant)."""
    shape = [s // 2, 2] * dim
    return a.reshape(shape).sum(axis=tuple(range(1, 2 * dim, 2))).reshape(-1)


def _finest_moments_scatter(pos, mass, ext, levels):
    """Order-2 finest-level moments about each body's own cell center as
    one [ncells, NM] array (NM = 1 + dim + dim*(dim+1)/2), via ONE wide row
    scatter-add."""
    dim = pos.shape[-1]
    g = 1 << levels
    cs = _cells(pos, ext, g)
    flat = _flatten_cells(cs, g)
    ncells = g ** dim
    pairs = _moment_pairs(dim)
    mins, csz = _cell_sizes(ext, g)
    r = [pos[:, d] - (mins[d] + (cs[d].astype(jnp.float32) + 0.5) * csz[d])
         for d in range(dim)]
    chans = ([mass] + [mass * r[d] for d in range(dim)]
             + [mass * r[a] * r[b] for a, b in pairs])
    return jnp.zeros((ncells, len(chans)), jnp.float32).at[flat].add(
        jnp.stack(chans, axis=1), mode="drop")


def _level_grids(pos, mass, ext, levels, order=1):
    """Per-level cell aggregates, any dimensionality (quadtree in 2-D,
    octree in 3-D; 2^(dim*levels) cells at the finest level).

    order=1: (M, S_0..S_{D-1}) with S about the origin (COM = S/M — adequate
    for monopole). order=2 instead keeps moments about EACH CELL'S CENTER —
    origin-relative second moments would catastrophically cancel in f32
    (Q ~ M*cell^2 against raw terms ~ M*x^2) — and pools them with
    parallel-axis shifts: about a new reference t_p = t_c + delta,
        S_a' = S_a - M d_a,
        S_ab' = S_ab - d_a S_b - d_b S_a + M d_a d_b   (r' = r - delta).
    """
    dim = pos.shape[-1]
    g = 1 << levels
    ncells = g ** dim

    def scatter_chans(chans):
        # ONE row scatter-add for all moment channels instead of one
        # scatter per channel: scatter cost is per update ROW, nearly
        # independent of row width
        flat = _flatten_cells(_cells(pos, ext, g), g)
        big = jnp.zeros((ncells, len(chans)), jnp.float32).at[flat].add(
            jnp.stack(chans, axis=1), mode="drop")
        return tuple(big[:, i] for i in range(len(chans)))

    if order < 2:
        chans = [mass] + [mass * pos[:, d] for d in range(dim)]
        grids = {levels: scatter_chans(chans)}
        for l in range(levels - 1, 1, -1):
            s = 1 << (l + 1)
            grids[l] = tuple(_pool(a, s, dim) for a in grids[l + 1])
        return grids

    # order 2: finest-level moments about each body's own cell center
    pairs = _moment_pairs(dim)
    finest = _finest_moments_scatter(pos, mass, ext, levels)
    grids = {levels: tuple(finest[:, i] for i in range(finest.shape[1]))}
    for l in range(levels - 1, 1, -1):
        s = 1 << (l + 1)                      # child grid side
        arrs = grids[l + 1]
        M = arrs[0]
        S1 = list(arrs[1:1 + dim])
        S2 = list(arrs[1 + dim:])
        # child-center offset from parent center: +/- child_cell/2 per axis;
        # axis-d parity of a flat row-major id (x fastest, stride s^d) is
        # (id // s^d) & 1 (s is even)
        _, ccsz = _cell_sizes(ext, s)
        iota = lax.broadcasted_iota(jnp.int32, (s ** dim, 1), 0).squeeze(-1)
        delta = [jnp.where(((iota // (s ** d)) & 1) == 0,
                           0.5 * ccsz[d], -0.5 * ccsz[d])
                 for d in range(dim)]
        S2n = [S2[k] - delta[a] * S1[b] - delta[b] * S1[a]
               + M * delta[a] * delta[b]
               for k, (a, b) in enumerate(pairs)]
        S1n = [S1[d] - M * delta[d] for d in range(dim)]
        grids[l] = tuple(_pool(a, s, dim) for a in [M] + S1n + S2n)
    return grids


# levels up to this many cells skip gathers (not yet re-measured on the GPU)
_DENSE_FAR_CELLS = {2: 256, 3: 512}


def _far_window_force(pxs, ws, use, cellrow, ext, g, eps2, order):
    """Monopole(+quadrupole) force of one level's interaction-list window.

    Broadcast-generic: ``pxs`` are per-axis body coordinates, ``ws`` per-axis
    window cell indices, ``use`` the membership mask, ``cellrow`` the cell
    aggregates with a trailing channel axis — any mutually-broadcastable
    leading shapes (the per-body pass uses [C,1] x [C,W]; the per-cell pass
    uses [Cc,ci,1] x [Cc,1,W], which XLA fuses without materializing the
    [Cc,ci,W] expansion). Returns per-axis force arrays; the caller reduces
    over the window axis.

    order=1: cell mass at its COM. order=2 adds the quadrupole term — the
    second-order Taylor expansion of u/|u|^3 about the COM (the first-order
    term vanishes there): with d = COM - p, r = |d|, central moments Q,
        F_quad = 1/2 [ -3 r^-5 (2 Q d + d tr Q) + 15 r^-7 (d^T Q d) d ].
    """
    dim = len(pxs)
    pairs = _moment_pairs(dim)
    M = jnp.where(use, cellrow[..., 0], 0.0)
    has = M > 0
    Minv = 1.0 / jnp.where(has, M, 1.0)
    if order >= 2:
        # moments are about the cell center (see _level_grids)
        mins, csz = _cell_sizes(ext, g)
        com = [mins[d] + (ws[d].astype(jnp.float32) + 0.5) * csz[d]
               + cellrow[..., 1 + d] * Minv for d in range(dim)]
    else:
        com = [cellrow[..., 1 + d] * Minv for d in range(dim)]
    dv = [jnp.where(has, com[d] - pxs[d], 0.0) for d in range(dim)]
    d2 = dv[0] * dv[0]
    for c2 in dv[1:]:
        d2 = d2 + c2 * c2
    d2 = d2 + eps2
    inv = lax.rsqrt(jnp.where(has, d2, 1.0))
    inv2 = inv * inv
    inv3 = inv2 * inv
    wgt = jnp.where(has, M * inv3, 0.0)
    f = [wgt * dv[d] for d in range(dim)]
    if order >= 2:
        # central (about-COM) moments from about-center moments:
        # Q = S2 - (S1/M) S1^T. Mask the channels FIRST (excluded
        # cells keep Minv=1, and S1*S1 there reaches ~1e45 -> inf,
        # which no later 0-multiply can cancel: inf*0 = NaN). Divide
        # before squaring for the same overflow reason.
        s1 = [jnp.where(use, cellrow[..., 1 + d], 0.0)
              for d in range(dim)]
        rb = [s1[d] * Minv for d in range(dim)]
        q = {}
        for k, (a, b) in enumerate(pairs):
            q[a, b] = (jnp.where(use, cellrow[..., 1 + dim + k], 0.0)
                       - rb[a] * s1[b])
            q[b, a] = q[a, b]
        inv5 = inv3 * inv2
        # scale by inv5 BEFORE contracting with d: raw d^T Q d can
        # reach ~5e39 (Q ~ M cell^2 ~ 5e29, |d|^2 ~ 1e10) and
        # overflows f32
        u = [sum(q[a, b] * dv[b] for b in range(dim)) * inv5
             for a in range(dim)]               # (Q d) r^-5
        trq5 = sum(q[a, a] for a in range(dim)) * inv5
        dqd7 = sum(dv[a] * u[a] for a in range(dim)) * inv2
        coef = jnp.where(has, 1.0, 0.0)
        f = [f[a] + coef * (-1.5 * (2.0 * u[a] + dv[a] * trq5)
                            + 7.5 * dqd7 * dv[a])
             for a in range(dim)]
    return f


def _far_force(i_pos, pos, mass, ext, levels, ring, eps2, chunk, order=1,
               grids=None):
    """Far-field force for the i bodies (any subset), with grids aggregated
    from the full (pos, mass) partner set. Dimension-generic (2-D quadtree /
    3-D octree; the interaction-list window is win^dim cells per level).

    order=1: monopole (cell mass at its COM). order=2 adds the quadrupole
    term — the second-order Taylor expansion of u/|u|^3 about the COM (the
    first-order term vanishes there): with d = COM - p, r = |d|, and central
    second moments Q,
        F_quad = 1/2 [ -3 r^-5 (2 Q d + d tr Q) + 15 r^-7 (d^T Q d) d ],
    cutting the opening-ratio error from O((s/d)^2) to O((s/d)^3) — roughly
    ring=2 accuracy at ring=1 cost.

    Coarse levels (grid <= _DENSE_FAR_CELLS[dim] cells) are evaluated DENSELY
    over every cell with the interaction-list membership computed in-register
    — identical cell set to the gathered window, but zero gathers: a
    [chunk, few-hundred]-cell elementwise pass costs little next to the
    row gathers it replaces.
    """
    dim = pos.shape[-1]
    if grids is None:
        grids = _level_grids(pos, mass, ext, levels, order)
    n = i_pos.shape[0]
    win = 4 * ring + 2
    offs = [lax.broadcasted_iota(jnp.int32, (win,) * dim, d).reshape(-1)
            for d in range(dim)]
    dense_cells = _DENSE_FAR_CELLS[dim]

    nchunks = -(-n // chunk)
    npad = nchunks * chunk
    pos_p = jnp.pad(i_pos, ((0, npad - n), (0, 0)))

    packed = {l: jnp.stack(grids[l], axis=1) for l in grids}  # [cells, ch]

    def one_chunk(c):
        pc = lax.dynamic_slice_in_dim(pos_p, c * chunk, chunk)
        force = jnp.zeros((chunk, dim), jnp.float32)
        for l in range(2, levels + 1):
            g = 1 << l
            cs = _cells(pc, ext, g)                     # dim x [C]
            ncells = g ** dim
            if ncells <= dense_cells:
                # dense: all cells as a [1, ncells] row, membership in-register
                cells = lax.broadcasted_iota(jnp.int32, (1, ncells), 1)
                ws, rem = [], cells
                for d in range(dim):                    # x fastest
                    ws.append(rem % g)
                    rem = rem // g
                near = jnp.bool_(True)
                parent_ok = jnp.bool_(True)
                for d in range(dim):
                    cd = cs[d][:, None]
                    near = near & (jnp.abs(ws[d] - cd) <= ring)
                    parent_ok = parent_ok & \
                        (jnp.abs((ws[d] >> 1) - (cd >> 1)) <= ring)
                use = parent_ok & ~near                 # [C, ncells]
                cellrow = packed[l][None, :, :]         # [1, ncells, ch]
            else:
                ws = [(((cs[d] >> 1) - ring) << 1)[:, None] + offs[d][None, :]
                      for d in range(dim)]              # [C, win^dim]
                near = jnp.bool_(True)
                inb = jnp.bool_(True)
                for d in range(dim):
                    near = near & (jnp.abs(ws[d] - cs[d][:, None]) <= ring)
                    inb = inb & (ws[d] >= 0) & (ws[d] < g)
                use = inb & ~near
                flat = jnp.clip(_flatten_cells(ws, g), 0, ncells - 1)
                cellrow = packed[l][flat]               # [C, win^dim, ch]
            f = _far_window_force([pc[:, d:d + 1] for d in range(dim)],
                                  ws, use, cellrow, ext, g, eps2, order)
            force = force + jnp.stack([jnp.sum(fa, axis=-1) for fa in f],
                                      axis=-1)
        return force

    if nchunks == 1:
        out = one_chunk(jnp.int32(0))[None]
    else:
        out = lax.map(one_chunk, jnp.arange(nchunks))
    return out.reshape(npad, dim)[:n]


def _pack_id(ids: jnp.ndarray):
    """Split i32 body ids across two exactly-f32-representable lanes:
    hi = id >> 12 (< 2^19 for any i32 id), lo = id & 0xFFF (< 2^12)."""
    ids = ids.astype(jnp.int32)
    return ((ids >> 12).astype(jnp.float32),
            (ids & 0xFFF).astype(jnp.float32))


def _unpack_id(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    return hi.astype(jnp.int32) * 4096 + lo.astype(jnp.int32)


def _gathered_pair_accum(pi, vi, mi, ri, ii, pj, vj, mj, rj, jj, *,
                         eps2, growth_rate, mode):
    """Exact per-pair semantics (mirrors pairwise.pair_accumulators_chunk)
    over per-body partner lists: i arrays are [C], j arrays are [C, M]
    gathered neighbors. Invalid/padded partners carry mass 0.
    Dimension-generic (positions/velocities are [..., D])."""
    dim = pi.shape[-1]
    alive = (mi > 0)[:, None] & (mj > 0)
    notself = ii[:, None] != jj
    valid = alive & notself

    dp = [pj[..., d] - pi[:, None, d] for d in range(dim)]
    d2 = dp[0] * dp[0]
    for c in dp[1:]:
        d2 = d2 + c * c
    rsum = ri[:, None] + rj
    overlap = (d2 <= rsum * rsum) & valid

    fmask = valid if mode == "elastic" else (valid & ~overlap)
    d2e = d2 + eps2
    safe = fmask & (d2e > 0)
    inv = lax.rsqrt(jnp.where(safe, d2e, 1.0))
    w = jnp.where(safe, mj * (inv * inv * inv), 0.0)
    force = jnp.stack([jnp.sum(w * c, axis=1) for c in dp], axis=1)

    out = empty_accumulators(ii, dim=dim)._replace(force=force)
    if mode == "reference":
        heavier = mi[:, None] >= mj
        merge = overlap & heavier
        out = out._replace(
            gained_mass=jnp.sum(jnp.where(merge, mj, 0.0), axis=1),
            gained_radius=jnp.sum(jnp.where(merge, rj * growth_rate, 0.0),
                                  axis=1),
            died=jnp.any(overlap & ~heavier, axis=1))
    elif mode == "momentum":
        beats = (mj > mi[:, None]) | ((mj == mi[:, None]) & (jj < ii[:, None]))
        cand = overlap & beats
        key = jnp.where(cand, mj, -jnp.inf)
        bm = jnp.max(key, axis=1)
        is_best = cand & (key == bm[:, None])
        order = jnp.where(is_best, -jj, jnp.iinfo(jnp.int32).min)
        best_local = jnp.argmax(order, axis=1)
        any_cand = jnp.any(cand, axis=1)
        parent = jnp.where(any_cand,
                           jnp.take_along_axis(jj, best_local[:, None],
                                               axis=1).squeeze(1),
                           ii).astype(jnp.int32)
        out = out._replace(best_mass=jnp.where(any_cand, bm, -jnp.inf),
                           parent=parent)
    elif mode == "elastic":
        vdotp = (vj[..., 0] - vi[:, None, 0]) * dp[0]
        for d in range(1, dim):
            vdotp = vdotp + (vj[..., d] - vi[:, None, d]) * dp[d]
        approaching = overlap & (vdotp < 0) & (d2 > 0)
        msum = mi[:, None] + mj
        coef = jnp.where(approaching,
                         2.0 * mj / jnp.where(msum > 0, msum, 1.0)
                         * vdotp / jnp.where(d2 > 0, d2, 1.0), 0.0)
        out = out._replace(dv=jnp.stack([jnp.sum(coef * c, axis=1)
                                         for c in dp], axis=1))
    elif mode != "none":
        raise ValueError(f"unknown collision mode {mode!r}")
    return out


def _partner_structure(pos, vel, mass, radius, ext, g, need_vel):
    """Cell-sorted partner structure shared by the near-field passes.

    Returns (order, s_cell, starts, ends, sf):
    - ``order``: sorted-position -> global body index (dead bodies in a
      trailing out-of-grid bucket);
    - ``s_cell``: flat cell id per sorted position;
    - ``starts``/``ends``: per-cell [start, end) ranges into sorted order;
    - ``sf``: one packed f32 feature row per sorted partner. One wide gather
      per neighbor window instead of six narrow ones (gather cost is per
      gathered row). The global id rides two f32 lanes (12-bit lo, upper bits
      hi, each exactly representable), so ids are exact at any i32-indexable
      N. Only elastic mode packs partner velocities — 25% less gather
      traffic in 2-D for the other modes (dim+4 vs 2*dim+4 lanes). One zero
      row of tail padding: masked window rows gather pad row n — inert
      (mass 0) for every channel, so no post-gather select is needed.
    """
    dim = pos.shape[-1]
    n = pos.shape[0]
    ncells = g ** dim
    alive = mass > 0
    cell = jnp.where(alive, _flatten_cells(_cells(pos, ext, g), g),
                     ncells)                           # dead -> bucket
    # ONE stable sort carries the iota payload, so the sorted cell ids come
    # out of the sort itself, with no argsort + cell[order] re-gather
    # (stability matters: ties keep id order, which fixes slot occupancy
    # and f32 accumulation order, pinned by goldens)
    s_cell, order = lax.sort(
        (cell, jnp.arange(n, dtype=jnp.int32)), num_keys=1, is_stable=True)
    # per-cell [start, end) via histogram + cumsum instead of two
    # searchsorted passes (empty cells get starts == ends either way). The
    # cumsum runs
    # blocked ([rows, 128]: lane-wise scans over all rows in parallel +
    # one short row-offset scan) instead of XLA's flat 1-D cumsum
    occ = jnp.zeros((ncells + 1,), jnp.int32).at[cell].add(1)
    if ncells >= 256:                        # power of two -> 128 | ncells
        o2 = occ[:ncells].reshape(-1, 128)
        row = jnp.cumsum(o2, axis=1, dtype=jnp.int32)
        offs = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(row[:, -1], dtype=jnp.int32)])[:-1]
        ends = (row + offs[:, None]).reshape(-1)
    else:
        ends = jnp.cumsum(occ[:ncells], dtype=jnp.int32)
    starts = ends - occ[:ncells]
    # pack features FIRST, then ONE wide row gather by the sort order —
    # gather cost is per gathered ROW, so six 1-element column gathers
    # cost ~6x one 6-lane row
    id_hi, id_lo = _pack_id(jnp.arange(n, dtype=jnp.int32))
    lanes = [pos[:, d] for d in range(dim)]
    if need_vel:
        lanes += [vel[:, d] for d in range(dim)]
    lanes += [mass, radius, id_hi, id_lo]
    sf = jnp.pad(jnp.stack(lanes, axis=1)[order], ((0, 1), (0, 0)))
    return order, s_cell, starts, ends, sf


def _near_field(i_pos, i_vel, i_mass, i_radius, i_ids,
                pos, vel, mass, radius, ext, levels, ring, eps2,
                growth_rate, mode, k, chunk, _structure=None):
    """Exact accumulators of i bodies against their (2*ring+1)^dim finest-cell
    neighbors among the (global) partner set.

    The i side is decoupled from the partner structure: partners come from
    the full (pos, vel, mass, radius) arrays sorted by cell; i bodies are any
    subset (the same arrays on one device, the local shard when sharded) with
    their *global* ids in ``i_ids``. Accumulators return in i order — no
    unsorting needed.

    Window shape: the (2*ring+1) x-adjacent cells of one neighbor-grid ROW
    are adjacent cell ids, hence CONTIGUOUS in the sorted order — so each row
    is ONE gather window of up to ``k`` partners (``bhNeighborK`` is a
    per-row cap). (2*ring+1)^(dim-1) row windows replace (2*ring+1)^dim
    per-cell windows (3 rows in 2-D at ring=1, 9 in 3-D), and a crowded cell
    can borrow its row neighbors' unused slots.
    """
    import itertools

    dim = pos.shape[-1]
    n_i = i_pos.shape[0]
    n = pos.shape[0]
    g = 1 << levels
    need_vel = mode == "elastic"
    if _structure is None:
        _structure = _partner_structure(pos, vel, mass, radius, ext, g,
                                        need_vel)
    order, s_cell, starts, ends, sf = _structure

    nchunks = -(-n_i // chunk)
    npad = nchunks * chunk

    def padded(x):
        return jnp.pad(x, [(0, npad - n_i)] + [(0, 0)] * (x.ndim - 1))

    ip, iv = padded(i_pos), padded(i_vel)
    im, ir = padded(i_mass), padded(i_radius)
    iid = jnp.pad(i_ids.astype(jnp.int32), (0, npad - n_i),
                  constant_values=-1)
    ics = _cells(ip, ext, g)
    # dead i rows produce junk that the alive_i mask inside the pair math
    # zeroes; their neighbor window is whatever their stale position hashes to
    ks = lax.broadcasted_iota(jnp.int32, (1, k), 1)

    def one_chunk(c):
        s = c * chunk
        pi = lax.dynamic_slice_in_dim(ip, s, chunk)
        vi = lax.dynamic_slice_in_dim(iv, s, chunk)
        mi = lax.dynamic_slice_in_dim(im, s, chunk)
        ri = lax.dynamic_slice_in_dim(ir, s, chunk)
        ii = lax.dynamic_slice_in_dim(iid, s, chunk)
        ccs = [lax.dynamic_slice_in_dim(a, s, chunk) for a in ics]
        acc = empty_accumulators(ii, dim=dim)
        # row cells [ccx-ring, ccx+ring] clamped into the grid are contiguous
        # in sorted order: one (start, count) range per non-x neighbor offset
        left = jnp.maximum(ccs[0] - ring, 0)
        right = jnp.minimum(ccs[0] + ring, g - 1)
        for off in itertools.product(range(-ring, ring + 1), repeat=dim - 1):
            nds = [ccs[1 + a] + off[a] for a in range(dim - 1)]
            ok_row = jnp.bool_(True)
            for nd in nds:
                ok_row = ok_row & (nd >= 0) & (nd < g)
            ndc = tuple(jnp.clip(nd, 0, g - 1) for nd in nds)
            st = starts[_flatten_cells((left,) + ndc, g)]
            cnt = jnp.minimum(ends[_flatten_cells((right,) + ndc, g)] - st, k)
            slots = st[:, None] + ks               # [C, k]
            ok = ok_row[:, None] & (ks < cnt[:, None])
            # per-row gather (sf[idx]); a vmapped [k, lanes] dynamic_slice
            # per window (gather with full slice_sizes) is the alternative,
            # not yet compared on the GPU
            idx = jnp.where(ok, slots, n)          # n = the zero pad row
            fj = sf[idx]                           # [C, k, lanes]
            pj = fj[..., 0:dim]
            if need_vel:
                vj = fj[..., dim:2 * dim]
                rest = 2 * dim
            else:
                vj = jnp.zeros_like(pj)
                rest = dim
            mj, rj = fj[..., rest], fj[..., rest + 1]
            jj = jnp.where(ok, _unpack_id(fj[..., rest + 2],
                                          fj[..., rest + 3]), -1)
            acc = combine_accumulators(acc, _gathered_pair_accum(
                pi, vi, mi, ri, ii, pj, vj, mj, rj, jj,
                eps2=eps2, growth_rate=growth_rate, mode=mode))
        return acc

    if nchunks == 1:
        acc = jax.tree.map(lambda x: x[None], one_chunk(jnp.int32(0)))
    else:
        acc = lax.map(one_chunk, jnp.arange(nchunks))
    return jax.tree.map(lambda x: x.reshape((npad,) + x.shape[2:])[:n_i], acc)


def _slot_unsort_idx(pos, mass, ext, g, order, starts, s_cell, ncells,
                     ci_cap, cell_range, nslots):
    """Body -> per-cell-slot index map for gather-based unsorting of slot
    arrays (slot = (cell - base) * ci_cap + rank): returns (valid, idx)
    with idx = nslots (a pad row) where invalid. One i32 scatter (the
    sorted ranks back to body order — its source expression is shared
    with the completion pass's srank, so the old inverse-permutation
    scatter + starts[cell] gather collapse to this single scatter);
    everything else is elementwise."""
    n = pos.shape[0]
    srank = (jnp.arange(n, dtype=jnp.int32)
             - starts[jnp.clip(s_cell, 0, ncells - 1)])
    rank_b = jnp.zeros((n,), jnp.int32).at[order].set(srank)
    alive_b = mass > 0
    cellb = jnp.where(alive_b, _flatten_cells(_cells(pos, ext, g), g),
                      ncells)
    base = jnp.int32(0) if cell_range is None else cell_range[0]
    rel = cellb - base
    n_eval = ncells if cell_range is None else cell_range[1]
    valid = (alive_b & (rank_b >= 0) & (rank_b < ci_cap)
             & (rel >= 0) & (rel < n_eval))
    return valid, jnp.where(valid, rel * ci_cap + rank_b, nslots)


_CI_CAP = 32  # floor of the per-cell i-slot budget (2x the occupancy-16
#               tuning the fixed cap was born with; slot_cap scales it)


def slot_cap(n: int, ncells: int) -> int:
    """Per-cell i-slot budget for the fast per-cell passes: 2x the average
    occupancy (the same headroom the original fixed 32 gave the occupancy-16
    grid), a multiple of 8, floored at 32.

    Density-aware so coarser-than-occupancy-16 grids stay eligible: with a
    fixed cap, occupancy-64 grids flooded the per-body completion budget,
    which blocked the levels that
    minimize window-gather traffic — in 3-D the occupancy-16 ceil overshoots
    to occupancy ~4 (8x slot padding), and the coarser grid needs cap ~2x64.
    The 1024 ceiling keeps one cell chunk's slot block bounded."""
    occ = -(-n // max(1, ncells))
    return int(min(1024, max(_CI_CAP, 8 * -(-2 * occ // 8))))


def _completion_cap(n: int, cap: int = 0) -> int:
    """Static budget of crowded-cell bodies finished by the per-body pass.
    A nonzero ``cap`` (the ``bhCompCap`` knob; pick_levels raises it
    count-aware when the default would drop bodies) overrides the ~n/16
    heuristic."""
    if cap:
        return min(n, cap)
    return min(n, max(1024, n // 16))


# mid-tier completion budget (see _tiered; not yet re-measured on the GPU)
_COMP_TIER = 1024


def _tiered(ps, n, run, carry):
    """Run ``run(carry, ps_slice)`` with the smallest sufficient static
    budget: nothing when the completion list ``ps`` is empty (fill value
    ``n`` marks unused slots), a _COMP_TIER-long prefix when the real
    entries fit in it (ps comes from jnp.nonzero, so they are a prefix),
    the full list otherwise."""
    real = jnp.sum((ps < n).astype(jnp.int32))
    small = min(_COMP_TIER, ps.shape[0])
    return lax.cond(
        real == 0, lambda c: c,
        lambda c: lax.cond(
            real <= small,
            lambda c2: run(c2, lax.slice_in_dim(ps, 0, small)),
            lambda c2: run(c2, ps), c),
        carry)


def _tiered_completion(over, n, comp_range, comp_cap, run, carry):
    """_completion_slice + _tiered with the ``jnp.nonzero`` itself gated
    behind an any-overflow cond: the nonzero's N-element cumsum would
    otherwise run even on scenes that never overflow. Clean (typical)
    scenes skip it entirely; crowded scenes pay
    one extra reduce — and, with several completion passes per step, one
    un-CSE-able nonzero per cond (~0.2% of the N=4M galaxy step, where
    the completion work itself dominates)."""
    total = jnp.sum(over.astype(jnp.int32))

    def nonempty(c):
        ps = _completion_slice(over, n, comp_range, comp_cap)
        return _tiered(ps, n, run, c)

    return lax.cond(total == 0, lambda c: c, nonempty, carry)


def _completion_slice(over, n, comp_range, comp_cap: int = 0):
    """The (sliced) static-size list of sorted-positions needing the exact
    per-body completion pass; fill value n marks unused slots."""
    if comp_range is None:
        size, base, length = _completion_cap(n, comp_cap), None, None
    else:
        base, length, size = comp_range
    ps = jnp.nonzero(over, size=size, fill_value=n)[0].astype(jnp.int32)
    if base is not None:
        ps = lax.dynamic_slice_in_dim(ps, base, length)
    return ps


def _build_slot_grid(sf, starts, ends, n, ncells, S):
    """The global partner slot grid [ncells, S, L]: each cell's first S
    sorted rows, inert pad rows past its count. One wide gather — the
    single most expensive near-build op."""
    pslots = (starts[:, None]
              + lax.broadcasted_iota(jnp.int32, (ncells, S), 1))
    p_ok = pslots < jnp.minimum(ends, starts + S)[:, None]
    return sf[jnp.where(p_ok, pslots, n)]


def _near_field_cells(pos, vel, mass, radius, ext, levels, ring, eps2,
                      growth_rate, mode, k, ci_cap: int = _CI_CAP,
                      chunk: int = 8192, _structure=None,
                      cell_range=None, comp_range=None,
                      near: str = "rows",
                      comp_cap: int = 0,
                      _fslot=None,
                      far_slot_lanes=None) -> PairAccumulators:
    """Near field for the FULL body set (i side == partner set): per-CELL
    shared windows, via one of two engines.

    ``near="rows"`` (default): per-cell window GATHERS. All bodies in one
    finest cell share identical neighbor-row windows, so the
    (2*ring+1)^(dim-1) row gathers of up to ``k`` sorted rows happen once
    per CELL instead of once per body (~occupancy x fewer gathered rows).
    ``k`` caps a whole (2*ring+1)-cell window ROW — rows aggregate over
    cells, so a tight cap (~1.33x the mean row population) covers the
    Poisson tail and the pair math stays minimal. Fastest on near-uniform
    scenes; clustered cells overflow the row cap and force grid refinement.

    ``near="slots"``: window SLICES over a partner slot grid. Bodies are
    packed once into a per-cell slot grid (each cell's first
    max(k, ci_cap) sorted bodies; inert zero rows elsewhere) with a single
    [ncells * slots]-row gather. Every neighbor window is then a
    CONTIGUOUS SLICE of that grid — window cells are adjacent flat ids,
    and a cell's slots are adjacent slot rows — so the rows engine's
    gather stream (ncells x rows x K rows) becomes dense slice traffic at
    device-memory bandwidth. ``k`` caps the partners visible
    PER NEIGHBOR CELL (per-row coverage is (2*ring+1)*k), which absorbs
    clustering a shared row cap cannot: the N=1M galaxy runs
    overflow-free at the uniform-density grid, while uniform scenes pay
    ~1.9x the (cheap, fused) pair math for the padding. The driver's
    ``bhNear=auto`` picks per scene.

    The pair math is identical in both (_gathered_pair_accum); the j
    window is broadcast across the cell's i slots, which XLA fuses.

    Each cell's first ``ci_cap`` sorted bodies ride the per-cell pass; the
    rest (only cells beyond 2x the target occupancy have any) are finished
    by the per-body pass (_near_field) over up to
    _completion_cap(n, comp_cap) such bodies, reusing the same sorted
    structure — identical windows and pair math, with one engine-specific
    coverage nuance: completion caps partners per window ROW ((2*ring+1)*S
    for slots, ``k`` for rows), whereas the slots fast pass caps them per
    CELL (S each). When some cell holds more than S bodies, a completion
    body can therefore see hot-cell partners ranked [S, (2*ring+1)*S) that
    slot-pass bodies in the same window cannot — a truncation-shape
    difference, not extra error: under auto knobs pick_levels sizes S to
    the densest cell (zero partner-cap overflow), where the two coverages
    coincide exactly. Only past the completion budget do bodies lose their
    near field — ``overflow_count`` reports them alongside the partner-cap
    overflow.

    ``cell_range=(base, count)`` (traced base, static power-of-two count)
    restricts the per-cell pass to that contiguous cell slice, and
    ``comp_range=(base, length, total)`` to that slice of the global
    completion list — the cell-sharded evaluation hooks (bodies outside the
    ranges keep identity accumulators; see bh_cellrange_accumulators). The
    slot grid is always GLOBAL: windows cross shard boundaries.
    """
    use_slots = near == "slots"
    pos, vel, mass, radius = map(jnp.asarray, (pos, vel, mass, radius))
    dim = pos.shape[-1]
    n = pos.shape[0]
    g = 1 << levels
    ncells = g ** dim
    need_vel = mode == "elastic"
    structure = (_structure if _structure is not None else
                 _partner_structure(pos, vel, mass, radius, ext, g, need_vel))
    order, s_cell, starts, ends, sf = structure
    rest = 2 * dim if need_vel else dim
    import itertools

    ncells_eval = ncells if cell_range is None else cell_range[1]
    cell_base = jnp.int32(0) if cell_range is None else cell_range[0]
    cell_chunk = max(1, min(ncells_eval, (2 * chunk) // ci_cap))
    cell_chunk = 1 << (cell_chunk.bit_length() - 1)   # power of 2 ...
    nchunks = ncells_eval // cell_chunk     # ... so it divides ncells_eval
    B = cell_chunk * ci_cap
    L = sf.shape[1]
    S = max(k, ci_cap)
    win = 2 * ring + 1

    if use_slots:
        # the global partner slot grid (one gather; all windows slice it).
        # _fslot is the caller-shared copy (_bh_cells_eval builds it once
        # for the near pass AND the annulus i-side — the gather is the
        # single most expensive build op).
        fslot = _fslot if _fslot is not None else _build_slot_grid(
            sf, starts, ends, n, ncells, S)
        padc = ring * sum(g ** d for d in range(dim))    # max window reach
        fslot_flat = jnp.pad(fslot.reshape(ncells * S, L),
                             ((padc * S, padc * S), (0, 0)))
    else:
        ks = lax.broadcasted_iota(jnp.int32, (1, k), 1)
        slots_i = lax.broadcasted_iota(jnp.int32, (1, ci_cap), 1)

    def one_chunk(c):
        base = cell_base + c * cell_chunk
        cid = base + lax.broadcasted_iota(jnp.int32, (cell_chunk, 1),
                                          0).squeeze(-1)
        coords = []
        rem = cid
        for _ in range(dim):                # x fastest
            coords.append(rem % g)
            rem = rem // g
        if use_slots:
            # i slots: the first ci_cap slot rows of each cell (a slice;
            # slots of dead/empty ranks carry the inert pad row and compute
            # junk the body-order unsort never reads)
            fi = lax.dynamic_slice(
                fslot, (base, 0, 0), (cell_chunk, ci_cap, L)).reshape(B, L)
        else:
            st_c = starts[cid]
            # i slots: the first ci_cap sorted bodies of each cell
            isl = st_c[:, None] + slots_i                   # [Cc, ci]
            i_ok = isl < jnp.minimum(ends[cid], st_c + ci_cap)[:, None]
            fi = sf[jnp.where(i_ok, isl, n)].reshape(B, L)
        pi = fi[:, 0:dim]
        vi = fi[:, dim:2 * dim] if need_vel else jnp.zeros_like(pi)
        mi, ri = fi[:, rest], fi[:, rest + 1]
        ii = _unpack_id(fi[:, rest + 2], fi[:, rest + 3])
        acc = empty_accumulators(ii, dim=dim)
        if not use_slots:
            left = jnp.maximum(coords[0] - ring, 0)
            right = jnp.minimum(coords[0] + ring, g - 1)
        for off in itertools.product(range(-ring, ring + 1), repeat=dim - 1):
            ok_row = jnp.bool_(True)
            for a, o in enumerate(off):
                nd = coords[1 + a] + o
                ok_row = ok_row & (nd >= 0) & (nd < g)
            if use_slots:
                koff = sum(off[a] * g ** (1 + a) for a in range(dim - 1))
                blk = lax.dynamic_slice(
                    fslot_flat, ((base + koff - ring + padc) * S, 0),
                    ((cell_chunk + 2 * ring) * S, L)
                ).reshape(cell_chunk + 2 * ring, S, L)
                parts, oks = [], []
                for dx in range(-ring, ring + 1):
                    parts.append(lax.slice_in_dim(blk, dx + ring,
                                                  dx + ring + cell_chunk))
                    oks.append(ok_row & (coords[0] + dx >= 0)
                               & (coords[0] + dx < g))
                fj = jnp.stack(parts, axis=1).reshape(cell_chunk,
                                                      win * S, L)
                ok = jnp.stack(oks, axis=1)              # [Cc, win]
                fjE = jnp.broadcast_to(
                    fj[:, None], (cell_chunk, ci_cap, win * S, L)
                ).reshape(B, win * S, L)
                okE = jnp.broadcast_to(
                    ok[:, None, :, None], (cell_chunk, ci_cap, win, S)
                ).reshape(B, win * S)
            else:
                ndc = tuple(jnp.clip(coords[1 + a] + off[a], 0, g - 1)
                            for a in range(dim - 1))
                st = starts[_flatten_cells((left,) + ndc, g)]
                cnt = jnp.minimum(
                    ends[_flatten_cells((right,) + ndc, g)] - st, k)
                ok = ok_row[:, None] & (ks < cnt[:, None])  # [Cc, k]
                fj = sf[jnp.where(ok, st[:, None] + ks, n)]  # [Cc, k, L]
                # expand the per-cell window across the cell's i slots
                fjE = jnp.broadcast_to(
                    fj[:, None], (cell_chunk, ci_cap) + fj.shape[1:]
                ).reshape(B, k, L)
                okE = jnp.broadcast_to(
                    ok[:, None], (cell_chunk, ci_cap, k)).reshape(B, k)
            pj = fjE[..., 0:dim]
            vj = fjE[..., dim:2 * dim] if need_vel else jnp.zeros_like(pj)
            # masked window slots (out-of-grid cells / beyond-count rows)
            # are neutralized by zeroing the partner mass — every pair
            # channel carries an m_j > 0 gate
            mj = fjE[..., rest] * okE
            rj = fjE[..., rest + 1]
            jj = _unpack_id(fjE[..., rest + 2], fjE[..., rest + 3])
            acc = combine_accumulators(acc, _gathered_pair_accum(
                pi, vi, mi, ri, ii, pj, vj, mj, rj, jj,
                eps2=eps2, growth_rate=growth_rate, mode=mode))
        return acc

    if nchunks == 1:
        acc = jax.tree.map(lambda x: x[None], one_chunk(jnp.int32(0)))
    else:
        acc = lax.map(one_chunk, jnp.arange(nchunks))
    flat = lambda x: x.reshape((nchunks * B,) + x.shape[2:])
    acc = jax.tree.map(flat, acc)

    # Unsort slot results into body order with a packed-row GATHER per
    # body instead of per-lane scatters of every slot (the one remaining
    # scatter is the i32 inverse permutation). Each body knows its slot
    # arithmetically: slot = (cell - cell_base) * ci_cap + rank, valid
    # while rank < ci_cap and the cell is in range; everything else
    # keeps identity lanes.
    nslots = nchunks * B
    lanes = [acc.force[:, d] for d in range(dim)]
    if mode == "reference":
        lanes += [acc.gained_mass, acc.gained_radius,
                  acc.died.astype(jnp.float32)]
    elif mode == "momentum":
        p_hi, p_lo = _pack_id(acc.parent)
        lanes += [acc.best_mass, p_hi, p_lo]
    elif mode == "elastic":
        lanes += [acc.dv[:, d] for d in range(dim)]
    packed_core = jnp.stack(lanes, axis=1)

    if far_slot_lanes is not None:
        # the caller's per-SLOT far-field forces (slot-side L2P + annulus)
        # ride the same unsort gather as the near channels — one combined
        # row per body instead of separate far gathers/unsorts
        packed_core = jnp.concatenate([packed_core, far_slot_lanes], axis=1)
    packed_sl = jnp.pad(packed_core, ((0, 1), (0, 0)))

    valid, slot_idx = _slot_unsort_idx(pos, mass, ext, g, order, starts,
                                       s_cell, ncells, ci_cap, cell_range,
                                       nslots)
    row = packed_sl[slot_idx]
    ids_b = jnp.arange(n, dtype=jnp.int32)
    out = empty_accumulators(jnp.arange(n + 1, dtype=jnp.int32), dim=dim)
    vcol = valid[:, None]
    force = row[:, 0:dim]
    if far_slot_lanes is not None:
        force = force + row[:, -dim:]
    force = jnp.pad(jnp.where(vcol, force, 0.0), ((0, 1), (0, 0)))
    out = out._replace(force=force)
    pad1 = lambda x, cv=0.0: jnp.pad(x, (0, 1), constant_values=cv)
    if mode == "reference":
        out = out._replace(
            gained_mass=pad1(jnp.where(valid, row[:, dim], 0.0)),
            gained_radius=pad1(jnp.where(valid, row[:, dim + 1], 0.0)),
            died=pad1(valid & (row[:, dim + 2] > 0.5), False))
    elif mode == "momentum":
        out = out._replace(
            best_mass=pad1(jnp.where(valid, row[:, dim], -jnp.inf),
                           -jnp.inf),
            parent=jnp.pad(jnp.where(
                valid, _unpack_id(row[:, dim + 1], row[:, dim + 2]),
                ids_b), (0, 1), constant_values=n))
    elif mode == "elastic":
        out = out._replace(dv=jnp.pad(
            jnp.where(vcol, row[:, dim:2 * dim], 0.0), ((0, 1), (0, 0))))

    # completion: bodies past their cell's ci_cap slots get the exact
    # per-body treatment (identical window semantics), bounded by m_cap
    srank = (jnp.arange(n, dtype=jnp.int32)
             - starts[jnp.clip(s_cell, 0, ncells - 1)])
    over = (srank >= ci_cap) & (s_cell < ncells)

    def run_completion(out, psx):
        gi = order[jnp.clip(psx, 0, n - 1)]  # fills -> a real body, dropped
        osidx = jnp.where(psx < n, gi, n)    # ... by scattering to row n
        # match the fast pass's per-row coverage: rows sees k per window
        # row; slots sees S = max(k, ci_cap) per CELL (the slot grid is
        # sized S so the i slice can ride it, and all S rows serve as
        # partners), i.e. (2*ring+1)*S per row
        row_k = (2 * ring + 1) * S if use_slots else k
        oacc = _near_field(pos[gi], vel[gi], mass[gi], radius[gi], gi,
                           pos, vel, mass, radius, ext, levels, ring, eps2,
                           growth_rate, mode, row_k,
                           min(psx.shape[0], chunk), _structure=structure)
        return PairAccumulators(*[o.at[osidx].set(s)
                                  for o, s in zip(out, oacc)])

    # The completion budget is a static worst case (~n/16 per-body windows —
    # as many gathered rows as the whole fast pass). Tier it: skip entirely
    # when nothing in range overflowed, run a _COMP_TIER-body slice for the
    # Poisson-tail trickle a uniform scene always has, and pay the full
    # budget only for genuinely clustered states.
    out = _tiered_completion(over, n, comp_range, comp_cap,
                             run_completion, out)
    return jax.tree.map(lambda x: x[:n], out)


def _far_force_cells(pos, mass, ext, levels, ring, eps2, order, structure,
                     ci_cap: int = _CI_CAP, chunk: int = 8192,
                     cell_range=None, grids=None):
    """Far field for the FULL body set via per-CELL window gathers.

    Bodies sharing a finest cell share their level-l cell at EVERY coarser
    level, hence every interaction-list window — so, like the near field,
    the per-level window gathers happen once per finest CELL instead of once
    per body (~occupancy x fewer gathered rows). The expansion math runs
    per (slot, window-cell) as a broadcast the compiler fuses — no
    materialized [slots, window] blowup.

    Same slot/completion scheme as _near_field_cells: each cell's first
    ``ci_cap`` sorted bodies ride this pass; the (rare, bounded) rest go
    through the per-body _far_force in the caller. Returns
    (force[ncells*ci_cap, dim], scatter_idx[ncells*ci_cap]) in slot order;
    invalid slots point at scatter row n.
    """
    dim = pos.shape[-1]
    n = pos.shape[0]
    g_f = 1 << levels
    ncells = g_f ** dim
    order_idx, s_cell, starts, ends, sf = structure
    if grids is None:
        grids = _level_grids(pos, mass, ext, levels, order)
    packed = {l: jnp.stack(grids[l], axis=1) for l in grids}
    win = 4 * ring + 2
    offs = [lax.broadcasted_iota(jnp.int32, (win,) * dim, d).reshape(-1)
            for d in range(dim)]
    dense_cells = _DENSE_FAR_CELLS[dim]

    ncells_eval = ncells if cell_range is None else cell_range[1]
    cell_base = jnp.int32(0) if cell_range is None else cell_range[0]
    cell_chunk = max(1, min(ncells_eval, (2 * chunk) // ci_cap))
    cell_chunk = 1 << (cell_chunk.bit_length() - 1)
    nchunks = ncells_eval // cell_chunk
    slots_i = lax.broadcasted_iota(jnp.int32, (1, ci_cap), 1)
    B = cell_chunk * ci_cap

    def one_chunk(c):
        cid = (cell_base + c * cell_chunk
               + lax.broadcasted_iota(jnp.int32, (cell_chunk, 1),
                                      0).squeeze(-1))
        fcoords = []
        rem = cid
        for _ in range(dim):                # x fastest
            fcoords.append(rem % g_f)
            rem = rem // g_f
        st_c = starts[cid]
        isl = st_c[:, None] + slots_i                       # [Cc, ci]
        i_ok = isl < jnp.minimum(ends[cid], st_c + ci_cap)[:, None]
        fi = sf[jnp.where(i_ok, isl, n)]                    # [Cc, ci, L]
        # slot positions [Cc, ci, 1] per axis; window arrays get a slot axis
        pxs = [fi[..., d:d + 1] for d in range(dim)]
        ii = _unpack_id(fi[..., -2], fi[..., -1])
        sidx = jnp.where(i_ok, ii, n).reshape(B)
        force = jnp.zeros((cell_chunk, ci_cap, dim), jnp.float32)
        for l in range(2, levels + 1):
            g = 1 << l
            cs = [fc >> (levels - l) for fc in fcoords]     # dim x [Cc]
            ncl = g ** dim
            if ncl <= dense_cells:
                cells = lax.broadcasted_iota(jnp.int32, (1, ncl), 1)
                ws, rem2 = [], cells
                for _ in range(dim):
                    ws.append(rem2 % g)
                    rem2 = rem2 // g
                near = jnp.bool_(True)
                parent_ok = jnp.bool_(True)
                for d in range(dim):
                    cd = cs[d][:, None]
                    near = near & (jnp.abs(ws[d] - cd) <= ring)
                    parent_ok = parent_ok & \
                        (jnp.abs((ws[d] >> 1) - (cd >> 1)) <= ring)
                use = parent_ok & ~near                     # [Cc, ncl]
                cellrow = packed[l][None, :, :]             # [1, ncl, ch]
            else:
                ws = [(((cs[d] >> 1) - ring) << 1)[:, None] + offs[d][None, :]
                      for d in range(dim)]                  # [Cc, win^dim]
                near = jnp.bool_(True)
                inb = jnp.bool_(True)
                for d in range(dim):
                    near = near & (jnp.abs(ws[d] - cs[d][:, None]) <= ring)
                    inb = inb & (ws[d] >= 0) & (ws[d] < g)
                use = inb & ~near
                flat = jnp.clip(_flatten_cells(ws, g), 0, ncl - 1)
                cellrow = packed[l][flat]                   # [Cc, win^dim, ch]
            # insert the slot axis: [Cc, 1, W(, ch)] against pxs [Cc, ci, 1]
            f = _far_window_force(pxs, [w[:, None] for w in ws],
                                  use[:, None], cellrow[:, None],
                                  ext, g, eps2, order)
            force = force + jnp.stack([jnp.sum(fa, axis=-1) for fa in f],
                                      axis=-1)
        return force.reshape(B, dim), sidx

    if nchunks == 1:
        force, sidx = one_chunk(jnp.int32(0))
        force, sidx = force[None], sidx[None]
    else:
        force, sidx = lax.map(one_chunk, jnp.arange(nchunks))
    return (force.reshape(nchunks * B, dim),
            sidx.reshape(nchunks * B))


# ---------------------------------------------------------------------------
# FMM far field: local expansions instead of per-cell window gathers.
#
# The gathered far passes above pay per gathered window row (216 cells per
# level in 3-D). But every interaction-list offset is a
# compile-time constant, so the "gather" of a whole level's windows is
# really a dense STENCIL: a static slice of the (padded) level grid per
# offset. The classic uniform-grid FMM then removes the per-body (and even
# per-finest-cell) level sweep entirely:
#
#   M2L  per level, per offset delta: every cell's window contribution to a
#        LOCAL force expansion about its own center — one [cells, n_src]
#        static slice x one tiny per-offset scalar matrix W[n_src, n_loc]
#        (the kernel derivatives at u = delta * cellsize, a traced scalar
#        per offset). Zero gathers; pure dense FMA/matmul.
#   L2L  parent expansions shift to child centers (upsample + Taylor shift).
#   L2P  each body evaluates its finest cell's expansion at its own offset
#        (one [N] row gather — the only gather in the whole far field).
#
# Truncation: the local expansion keeps every (source offset a, target
# offset y) Taylor term of total order <= degree (default 3), except source
# orders > 2 (the grids carry moments only to the quadrupole, exactly like
# the exact-target path) — so the dominant residual is the same source-
# octupole term as the gathered engine, and measured accuracy matches it
# (~1e-2 at ring=1, ~1e-3 at ring=2, order=2). Every block is a derivative
# tensor of the softened potential, hence fully symmetric: rank rho stores
# C(dim+rho-1, rho) distinct components (_fmm_layout).
#
# Parity bookkeeping: the interaction list at one level, for a target cell
# with per-axis parities p, spans per-axis offsets delta in
# [-2*ring - p, 2*ring + 1 - p] minus the all-near block (|delta| <= ring
# on every axis). Only the extreme offsets |delta| = 2*ring + 1 are parity-
# restricted; interior offsets apply to every cell. Near-block offsets are
# skipped statically; out-of-grid sources vanish via zero padding (every
# W column carries a moment factor, and u = delta * cellsize is never 0).
# ---------------------------------------------------------------------------


def _fmm_offsets(ring, dim):
    """Static interaction-list offsets: per-axis range [-(2r+1), 2r+1],
    minus the all-near block. Offsets are coordinate-order tuples
    (delta_x, delta_y[, delta_z])."""
    import itertools
    w = 2 * ring + 1
    offs = []
    for d in itertools.product(range(-w, w + 1), repeat=dim):
        if all(abs(x) <= ring for x in d):
            continue                     # the near block, handled exactly
        offs.append(d)
    return offs


def _sym_tuples(dim, rank):
    """Sorted index tuples (a1 <= ... <= a_rank) of a fully symmetric
    rank-``rank`` tensor over ``dim`` axes."""
    import itertools
    return list(itertools.combinations_with_replacement(range(dim), rank))


def _fmm_layout(dim, degree):
    """Local-expansion channel map. The expansion holds fully symmetric
    tensor blocks of rank 1..degree+1 (force F, Jacobian J, Hessian H, ...;
    all are derivatives of the scalar potential, hence symmetric in EVERY
    index including the force component). Returns (n_loc, idx) where
    idx[sorted index tuple] -> channel."""
    idx = {}
    off = 0
    for rank in range(1, degree + 2):
        for t in _sym_tuples(dim, rank):
            idx[t] = off
            off += 1
    return off, idx


def _fmm_nloc(dim, degree):
    return _fmm_layout(dim, degree)[0]


def _pairings(idx):
    """All partitions of an index tuple into unordered delta-pairs plus
    singles. Yields (pairs, singles) tuples."""
    if not idx:
        yield (), ()
        return
    first, rest = idx[0], idx[1:]
    for pairs, singles in _pairings(rest):
        yield pairs, (first,) + singles
    for i in range(len(rest)):
        for pairs, singles in _pairings(rest[:i] + rest[i + 1:]):
            yield ((first, rest[i]),) + pairs, singles


_DFACT = [1, 3, 15, 105, 945, 10395, 135135]    # (2t+1)!!


def _deriv_entry(idx, ut, inv_pows, _memo):
    """One entry of the derivative tensor of the softened force kernel
    K(u) = u / (|u|^2 + eps^2)^{3/2}: for idx = (i, j1..jr),
    d^r K_i / du_j1..du_jr. K is a pure gradient of the potential, so the
    tensor is fully symmetric; entries follow the classic pairing expansion
        sum over pairings of {idx} into q delta-pairs + s singles:
            (-1)^t (2t+1)!!  prod(delta_pair)  prod(ut_single)  inv^{r+2},
    t = r - q, with ut = u * inv normalized so every factor is O(1) (raw
    r^-9 underflows f32 at field scale)."""
    key = tuple(sorted(idx))
    if key in _memo:
        return _memo[key]
    r = len(idx) - 1
    total = None
    for pairs, singles in _pairings(key):
        if any(a != b for a, b in pairs):
            continue
        t = r - len(pairs)
        term = float((-1.0) ** t * _DFACT[t])
        for s in singles:
            term = term * ut[s]
        total = term if total is None else total + term
    total = (0.0 if total is None else total) * inv_pows[r + 2]
    _memo[key] = total
    return total


def _m2l_weights(deltas, csz, eps2, dim, order, degree):
    """W[noff, n_src, n_loc]: per-offset scalar matrices taking a cell's
    source moments (M, S1 about center, S2 about center) to its local
    expansion contribution, keeping every (source a, target y) Taylor term
    of total order <= ``degree`` except source orders > 2 (no octupole
    moments in the grids — the same source truncation as the exact-target
    quadrupole path). Block of rank rho, source of order sigma:
        W += (-1)^(rho-1) (mult_A / sigma!) D[I + A]
    with D the kernel derivative tensors (_deriv_entry). ``deltas`` is a
    static [noff, dim] int array; ``csz`` the traced per-axis cell size;
    order < 2 drops the S2 columns."""
    import math
    src = [((), 1.0)] + [((a,), 1.0) for a in range(dim)]
    if order >= 2:
        for (a, b) in _moment_pairs(dim):
            mult = 1.0 if a == b else 2.0
            src.append(((a, b), mult / 2.0))
    n_src = 1 + dim + len(_moment_pairs(dim))   # grid channel count (fixed)
    n_loc, lidx = _fmm_layout(dim, degree)
    u = jnp.stack([deltas[:, d].astype(jnp.float32) * csz[d]
                   for d in range(dim)], axis=-1)        # [noff, dim]
    inv = lax.rsqrt(jnp.sum(u * u, axis=-1) + eps2)      # [noff]
    ut = [u[..., d] * inv for d in range(dim)]
    inv_pows = {p: inv ** p for p in range(2, degree + 4)}
    memo = {}
    noff = u.shape[0]
    zero = jnp.zeros((noff,), jnp.float32)
    W = [[zero for _ in range(n_loc)] for _ in range(n_src)]
    for I, ch in lidx.items():
        rho = len(I)
        sign = (-1.0) ** (rho - 1)
        for si, (A, wA) in enumerate(src):
            if (rho - 1) + len(A) > degree:
                continue
            d = _deriv_entry(I + A, ut, inv_pows, memo)
            W[si][ch] = W[si][ch] + (sign * wA) * d
    return jnp.stack([jnp.stack(r, axis=-1) for r in W], axis=-2)


def _m2l_level(packed, s, ext, eps2, ring, dim, order, degree):
    """One level's M2L: local-expansion contributions [s^dim, n_loc] from
    the level's packed source grid [s^dim, n_src] via stencil slices (flat
    ids are row-major, x fastest). The stencil runs as ONE lax.scan over
    the static offset list — per step: one dynamic slice of the padded
    grid, a parity mask, and a tiny [n_src, n_loc] matmul — so the compiled
    graph stays a single body no matter how many offsets the ring has
    (1206 in 3-D at ring 2)."""
    nch = packed.shape[1]
    ncells = s ** dim
    w = 2 * ring + 1
    # spatial axes reversed (x is the last axis in C-order reshape)
    spat = packed.reshape((s,) * dim + (nch,))
    Gp = jnp.pad(spat, [(w, w)] * dim + [(0, 0)])
    _, csz = _cell_sizes(ext, s)
    offs = _fmm_offsets(ring, dim)
    deltas = np.asarray(offs, np.int32)                  # [noff, dim]
    W = _m2l_weights(jnp.asarray(deltas), csz, eps2, dim, order, degree)
    # parity restriction only at the extreme offsets delta = +-(2r+1):
    # delta=+w admits parity 0 only, delta=-w parity 1 only
    allow = np.stack([deltas != -w, deltas != w], axis=-1)  # [noff, dim, 2]
    starts = jnp.asarray(deltas + w)                     # slice starts
    pars = [((lax.broadcasted_iota(jnp.int32, (ncells,), 0) // (s ** d)) & 1)
            for d in range(dim)]

    # group G offsets per scan step: the unrolled group amortizes per-step
    # scan overhead while the scan keeps the compiled graph small
    # for the big 3-D stencils (1206 offsets at ring 2). Zero-weight
    # dummies pad the tail group.
    G = 8
    noff = len(offs)
    npad = -(-noff // G) * G
    allow_f = np.concatenate([np.asarray(allow, np.float32),
                              np.ones((npad - noff, dim, 2), np.float32)])
    starts_p = jnp.concatenate(
        [starts, jnp.full((npad - noff, dim), w, jnp.int32)])
    W_p = jnp.concatenate(
        [W, jnp.zeros((npad - noff,) + W.shape[1:], W.dtype)])

    def body(acc, xs):
        st, al, Wo = xs                  # [G, ...] per-group slices
        for o in range(G):
            sh = lax.dynamic_slice(
                Gp, [st[o, dim - 1 - ax] for ax in range(dim)] + [0],
                (s,) * dim + (nch,)).reshape(ncells, nch)
            m = jnp.float32(1.0)
            for d in range(dim):
                m = m * jnp.where(pars[d] == 0, al[o, d, 0], al[o, d, 1])
            acc = acc + jnp.matmul(sh * m[:, None], Wo[o],
                                   precision=lax.Precision.HIGHEST)
        return acc, None

    grp = lambda a: a.reshape((npad // G, G) + a.shape[1:])
    acc = jnp.zeros((ncells, _fmm_nloc(dim, degree)), jnp.float32)
    acc, _ = lax.scan(body, acc, (grp(starts_p), grp(jnp.asarray(allow_f)),
                                  grp(W_p)))
    return acc


# "conv" (parent-folded conv) | "scan" (offset sweep); env-overridable
# for A/B benchmarking without code edits (bench.bh_profile runs).
_M2L_ENGINE = os.environ.get("NBODYAX_M2L", "conv")


def _m2l_level_conv(packed, s, ext, eps2, ring, dim, order, degree):
    """`_m2l_level` re-expressed as ONE convolution over the PARENT grid.

    The scan form re-slices the whole padded grid once per offset (40/96
    offsets in 2-D at ring 1/2, 316/1206 in 3-D) — pure memory traffic,
    which grows with N. But the stencil is
    exactly translation-invariant over *parent* cells: fold each child's
    parity into a channel, and the parity-restriction rule at the extreme
    offsets (delta = +w only for parity-0 targets, -w only for parity-1)
    is precisely what confines every allowed (delta, target-parity) pair
    to a parent offset q = (delta + p) >> 1 in [-ring, ring]. Each
    (delta, p) maps to a UNIQUE (q, source-parity r = (delta + p) & 1), so
    the kernel assembles with one scatter and the whole level becomes a
    [2r+1]^dim conv with 2^dim*n_src in / 2^dim*n_loc out channels — read
    the grid once, one conv contraction.
    """
    nch = packed.shape[1]
    ncells = s ** dim
    sp = s // 2
    w = 2 * ring + 1
    ks = 2 * ring + 1                       # parent kernel side
    _, csz = _cell_sizes(ext, s)
    offs = _fmm_offsets(ring, dim)
    deltas = np.asarray(offs, np.int32)     # [noff, dim], coord d (x = 0)
    W = _m2l_weights(jnp.asarray(deltas), csz, eps2, dim, order, degree)
    n_loc = W.shape[-1]

    # kernel index lists (static numpy): one entry per allowed (delta, p)
    import itertools
    kf, rf, pf, oi = [], [], [], []
    for i, d in enumerate(deltas):
        for p in itertools.product((0, 1), repeat=dim):
            if any((d[k] == -w and p[k] == 0) or (d[k] == w and p[k] == 1)
                   for k in range(dim)):
                continue                    # the scan form's parity mask
            q = [(int(d[k]) + p[k]) >> 1 for k in range(dim)]
            r = [(int(d[k]) + p[k]) & 1 for k in range(dim)]
            assert all(-ring <= qk <= ring for qk in q)
            kf.append(sum((q[k] + ring) * ks ** k for k in range(dim)))
            rf.append(sum(r[k] << k for k in range(dim)))
            pf.append(sum(p[k] << k for k in range(dim)))
            oi.append(i)
    kflat = jnp.zeros((ks ** dim, 1 << dim, 1 << dim, nch, n_loc),
                      jnp.float32)
    kflat = kflat.at[np.asarray(kf), np.asarray(rf), np.asarray(pf)].set(
        W[np.asarray(oi)])
    # [spatial..., rflat*nch (in), pflat*n_loc (out)]; the flat spatial
    # index has coord d weighted ks^d (x fastest), so the row-major reshape
    # puts coord dim-1 on axis 0 — already matching the grid's axis order
    ker = kflat.reshape((ks,) * dim + kflat.shape[1:]).transpose(
        tuple(range(dim)) + (dim, dim + 2, dim + 1, dim + 3)).reshape(
        (ks,) * dim + ((1 << dim) * nch, (1 << dim) * n_loc))

    # fold children into parent channels: rflat = sum_d parity_d << d
    spat = packed.reshape((s,) * dim + (nch,))   # axes c_{D-1}, ..., c_0, ch
    spat = spat.reshape(sum(([sp, 2] for _ in range(dim)), []) + [nch])
    perm = tuple(2 * ax for ax in range(dim)) + tuple(
        2 * ax + 1 for ax in range(dim)) + (2 * dim,)
    folded = spat.transpose(perm).reshape((sp,) * dim + ((1 << dim) * nch,))

    dn = {2: ("NHWC", "HWIO", "NHWC"), 3: ("NDHWC", "DHWIO", "NDHWC")}[dim]
    out = lax.conv_general_dilated(
        folded[None], ker, window_strides=(1,) * dim,
        padding=[(ring, ring)] * dim, dimension_numbers=dn,
        precision=lax.Precision.HIGHEST)[0]

    # unfold parent channels back to the child-major flat layout
    out = out.reshape((sp,) * dim + (2,) * dim + (n_loc,))
    perm = sum(((ax, dim + ax) for ax in range(dim)), ()) + (2 * dim,)
    return out.transpose(perm).reshape(ncells, n_loc)


def _shifted_block(up, take_y, dim, degree, lidx, rank):
    """Taylor-shift one symmetric block: for every rank-``rank`` index
    tuple I, sum_m 1/m! B_{rank+m}[I + K] prod y_K over higher blocks.
    ``take_y(d)`` returns the axis-d shift array. Returns columns in
    _sym_tuples(dim, rank) order."""
    import itertools
    import math
    cols = []
    for I in _sym_tuples(dim, rank):
        c = None
        for m in range(0, degree + 2 - rank):
            f = 1.0 / math.factorial(m)
            for K in itertools.combinations_with_replacement(range(dim), m):
                # multiplicity: distinct permutations of K
                perms = math.factorial(m)
                for v in set(K):
                    perms //= math.factorial(K.count(v))
                term = up[:, lidx[tuple(sorted(I + K))]] * (f * perms)
                for k in K:
                    term = term * take_y(k)
                c = term if c is None else c + term
        cols.append(c)
    return cols


def _l2l(local, sp, dim, ext, degree):
    """Shift parent local expansions (side sp) to their 2^dim children
    (side 2*sp): upsample, then Taylor-shift every block by the child's
    center offset delta = (parity - 1/2) * child_cellsize."""
    _, lidx = _fmm_layout(dim, degree)
    s = 2 * sp
    ncells = s ** dim
    # upsample: parent flat (x fastest) -> child flat via [sp, 2]*dim axes
    spat = local.reshape((sp,) * dim + (local.shape[1],))
    up = spat
    for ax in range(dim):
        up = jnp.repeat(up, 2, axis=ax)
    up = up.reshape(ncells, local.shape[1])
    _, ccsz = _cell_sizes(ext, s)
    iota = lax.broadcasted_iota(jnp.int32, (ncells,), 0)
    delta = [jnp.where(((iota // (s ** d)) & 1) == 1, 0.5, -0.5) * ccsz[d]
             for d in range(dim)]
    cols = []
    for rank in range(1, degree + 2):
        cols.extend(_shifted_block(up, lambda d: delta[d], dim, degree,
                                   lidx, rank))
    return jnp.stack(cols, axis=1)


def _l2p(local, pos, ext, levels, dim, degree=3):
    """Evaluate each body's finest-cell local expansion at its own offset
    y from the cell center. One [N] row gather — the far field's only."""
    _, lidx = _fmm_layout(dim, degree)
    g = 1 << levels
    cs = _cells(pos, ext, g)
    mins, csz = _cell_sizes(ext, g)
    row = local[_flatten_cells(cs, g)]                    # [N, n_loc]
    y = [pos[:, d] - (mins[d] + (cs[d].astype(jnp.float32) + 0.5) * csz[d])
         for d in range(dim)]
    out = _shifted_block(row, lambda d: y[d], dim, degree, lidx, 1)
    return jnp.stack(out, axis=1)


def _l2p_slots(local, pslot, ext, levels, dim, degree=3, cell0=None):
    """L2P evaluated at each cell's SLOT positions: local rows are
    cell-major and slot positions come straight from the slot grid, so —
    unlike the per-body ``_l2p`` — there are ZERO gathers. ``pslot`` is
    [nc, ci, dim] (the slot grid's position lanes); ``cell0`` offsets the
    cell ids for a sharded contiguous slice. Returns [nc, ci, dim] forces;
    pad slots compute junk the unsort never reads.

    The math is _shifted_block at rank 1 (the force block of the Taylor
    series) with the per-cell expansion broadcast over the cell's slots."""
    import itertools
    import math
    _, lidx = _fmm_layout(dim, degree)
    g = 1 << levels
    nc = pslot.shape[0]
    mins, csz = _cell_sizes(ext, g)
    iota = lax.broadcasted_iota(jnp.int32, (nc, 1), 0)
    if cell0 is not None:
        iota = iota + cell0
    y = []
    rem = iota
    for d in range(dim):                     # x fastest
        cd = rem % g
        rem = rem // g
        ctr = mins[d] + (cd.astype(jnp.float32) + 0.5) * csz[d]
        y.append(pslot[..., d] - ctr)        # [nc, ci]
    cols = []
    for I in range(dim):
        c = None
        for m in range(0, degree + 1):
            f = 1.0 / math.factorial(m)
            for K in itertools.combinations_with_replacement(range(dim), m):
                perms = math.factorial(m)
                for v in set(K):
                    perms //= math.factorial(K.count(v))
                term = local[:, lidx[tuple(sorted((I,) + K))]][:, None] \
                    * (f * perms)
                for kk in K:
                    term = term * y[kk]
                c = term if c is None else c + term
        cols.append(c)
    return jnp.stack(cols, axis=-1)          # [nc, ci, dim]


def _fmm_local_table(pos, mass, ext, levels, ring, eps2, order, degree=3,
                     grids=None):
    """The finest-level local-expansion table [2^(dim*levels), n_loc]:
    M2L at every level (interaction lists at ring ``ring`` — the hybrid
    caller passes bhRing + 1) chained down by L2L. Evaluate at bodies with
    _l2p."""
    dim = pos.shape[-1]
    if grids is None:
        grids = _level_grids(pos, mass, ext, levels, order=2)
    local = None
    for l in range(2, levels + 1):
        s = 1 << l
        if local is not None:
            local = _l2l(local, s // 2, dim, ext, degree)
        packed = jnp.stack(grids[l], axis=1)
        m2l = _m2l_level_conv if _M2L_ENGINE == "conv" else _m2l_level
        contrib = m2l(packed, s, ext, eps2, ring, dim, order, degree)
        local = contrib if local is None else local + contrib
    return local


def _fmm_far_force(pos, mass, ext, levels, ring, eps2, order, degree=3,
                   grids=None):
    """Far-field force for EVERY body via dense local expansions:
    _fmm_local_table + one [N]-row _l2p gather."""
    local = _fmm_local_table(pos, mass, ext, levels, ring, eps2, order,
                             degree, grids)
    return _l2p(local, pos, ext, levels, pos.shape[-1], degree)




_ANN_G = 8   # annulus offsets unrolled per scan step


def _annulus_offsets(w_near, w_far, dim):
    """Static offsets of the finest-level mid shell:
    w_near < |delta|_inf <= w_far."""
    import itertools
    offs = []
    for d in itertools.product(range(-w_far, w_far + 1), repeat=dim):
        if all(abs(x) <= w_near for x in d):
            continue
        offs.append(d)
    return offs


def _annulus_force_cells(packed, ext, levels, w_near, w_far, eps2, order,
                         structure, ci_cap: int = _CI_CAP,
                         chunk: int = 8192, cell_range=None, fslot=None):
    """Exact-target force from the finest-level annulus cells
    (w_near < |delta|_inf <= w_far): the shell a local expansion would
    evaluate at its worst opening ratio, so the hybrid FMM hands it to the
    source-moment evaluation at each body's EXACT position instead
    (_far_window_force: monopole/quadrupole about the source cell center).

    Sources are one flat-shifted dynamic slice per offset — flat row-major
    ids are affine in the target id at one level, so there are ZERO gathers;
    targets are the per-cell slot positions (same slot scheme and scatter
    protocol as the per-cell passes: returns (force[slots, dim], sidx)).
    Out-of-grid wraps are masked per axis from the cell coordinates."""
    dim = len(ext[0])
    g = 1 << levels
    ncells = g ** dim
    order_idx, s_cell, starts, ends, sf = structure
    n = order_idx.shape[0]
    nch = packed.shape[1]
    offs = _annulus_offsets(w_near, w_far, dim)
    maxk = sum(w_far * g ** d for d in range(dim))
    Gp = jnp.pad(packed, ((maxk, maxk), (0, 0)))

    ncells_eval = ncells if cell_range is None else cell_range[1]
    cell_base = jnp.int32(0) if cell_range is None else cell_range[0]
    cell_chunk = max(1, min(ncells_eval, (2 * chunk) // ci_cap))
    cell_chunk = 1 << (cell_chunk.bit_length() - 1)
    nchunks = ncells_eval // cell_chunk
    slots_i = lax.broadcasted_iota(jnp.int32, (1, ci_cap), 1)
    B = cell_chunk * ci_cap

    def one_chunk(c):
        base = cell_base + c * cell_chunk
        cid = base + lax.broadcasted_iota(jnp.int32, (cell_chunk, 1),
                                          0).squeeze(-1)
        coords = []
        rem = cid
        for _ in range(dim):                # x fastest
            coords.append(rem % g)
            rem = rem // g
        # per-cell [start, end) via SLICES (cid is a contiguous range)
        st_c = lax.dynamic_slice_in_dim(starts, base, cell_chunk)
        en_c = lax.dynamic_slice_in_dim(ends, base, cell_chunk)
        isl = st_c[:, None] + slots_i                       # [Cc, ci]
        i_ok = isl < jnp.minimum(en_c, st_c + ci_cap)[:, None]
        if fslot is not None:
            # the caller's shared slot grid: the i slots are its first
            # ci_cap rows per cell — a SLICE, replacing this pass's own
            # [ncells*ci]-row gather
            fi = lax.dynamic_slice(
                fslot, (base, 0, 0),
                (cell_chunk, ci_cap, fslot.shape[-1]))
        else:
            fi = sf[jnp.where(i_ok, isl, n)]                # [Cc, ci, L]
        pxs = [fi[..., d:d + 1] for d in range(dim)]
        ii = _unpack_id(fi[..., -2], fi[..., -1])
        sidx = jnp.where(i_ok, ii, n).reshape(B)
        force = jnp.zeros((cell_chunk, ci_cap, dim), jnp.float32)

        def off_body(f, xs):
            kk, dl, ok_off = xs     # per-GROUP slices (see grouping below)
            for o in range(_ANN_G):
                row = lax.dynamic_slice_in_dim(Gp, base + maxk + kk[o],
                                               cell_chunk)
                ws = [coords[d] + dl[o, d] for d in range(dim)]
                okc = ok_off[o] > 0
                for d in range(dim):
                    okc = okc & (ws[d] >= 0) & (ws[d] < g)
                fo = _far_window_force(pxs, [w[:, None, None] for w in ws],
                                       okc[:, None, None],
                                       row[:, None, None, :],
                                       ext, g, eps2, order)
                f = f + jnp.stack([fa.squeeze(-1) for fa in fo], axis=-1)
            return f, None

        # G offsets unrolled per scan step (amortizes per-step overhead;
        # the scan bounds compile size for the 98-offset 3-D shell);
        # zero-valid dummies pad the tail group
        noff = len(offs)
        npad = -(-noff // _ANN_G) * _ANN_G
        dl_arr = np.zeros((npad, dim), np.int32)
        dl_arr[:noff] = np.asarray(offs, np.int32)
        kk_arr = np.zeros((npad,), np.int32)
        kk_arr[:noff] = [sum(o[d] * g ** d for d in range(dim))
                         for o in offs]
        ok_arr = np.zeros((npad,), np.float32)
        ok_arr[:noff] = 1.0
        grp = lambda a: jnp.asarray(a).reshape((npad // _ANN_G, _ANN_G)
                                               + a.shape[1:])
        force, _ = lax.scan(off_body, force,
                            (grp(kk_arr), grp(dl_arr), grp(ok_arr)))
        return force.reshape(B, dim), sidx

    if nchunks == 1:
        force, sidx = one_chunk(jnp.int32(0))
        force, sidx = force[None], sidx[None]
    else:
        force, sidx = lax.map(one_chunk, jnp.arange(nchunks))
    return (force.reshape(nchunks * B, dim), sidx.reshape(nchunks * B))


def _annulus_force_bodies(i_pos, packed, ext, levels, w_near, w_far, eps2,
                          order):
    """Per-body annulus force for a small body subset (the crowded-cell
    completion list): gathers the few shell source rows per body."""
    dim = i_pos.shape[-1]
    g = 1 << levels
    ncells = g ** dim
    offs = _annulus_offsets(w_near, w_far, dim)
    cs = _cells(i_pos, ext, g)
    flat = _flatten_cells(cs, g)
    nb = i_pos.shape[0]
    pxs = [i_pos[:, d:d + 1] for d in range(dim)]

    def off_body(f, xs):
        kk, dl = xs             # one scan body for the whole shell
        ws = [cs[d] + dl[d] for d in range(dim)]
        okc = jnp.bool_(True)
        for d in range(dim):
            okc = okc & (ws[d] >= 0) & (ws[d] < g)
        row = packed[jnp.clip(flat + kk, 0, ncells - 1)]    # [nb, ch]
        fo = _far_window_force(pxs, [w[:, None] for w in ws],
                               okc[:, None], row[:, None, :],
                               ext, g, eps2, order)
        return f + jnp.stack([fa.squeeze(-1) for fa in fo], axis=-1), None

    dl_arr = jnp.asarray(np.asarray(offs, np.int32))
    kk_arr = jnp.asarray([sum(o[d] * g ** d for d in range(dim))
                          for o in offs], dtype=jnp.int32)
    force, _ = lax.scan(off_body, jnp.zeros((nb, dim), jnp.float32),
                        (kk_arr, dl_arr))
    return force



def giant_collision_accumulators(pos, vel, mass, radius, *, ext, levels,
                                 ring, growth_rate, mode: str,
                                 n_giants: int,
                                 chunk: int = 16384,
                                 cell_range=None) -> PairAccumulators:
    """Exact COLLISION channels for the largest-radius bodies at any pair
    distance: the near window only covers overlaps with
    ``r_i + r_j <= ring * cell`` (module docstring, approximation 1), and
    merged "giants" outgrow that within steps of a merging run — the
    alternative, coarsening the whole grid to chase ``2*rmax``,
    multiplies near-field cost without bound (K 48 -> 688 inside 16 steps
    of the 4M galaxy; the reference evaluates every pair unconditionally,
    /root/reference/src/nbody.cu:196-226, so giants MUST keep eating).

    The top ``n_giants`` live bodies by radius (among those with
    ``radius > ring*cell/2`` — smaller bodies cannot form an uncovered
    overlap unless the partner qualifies as a giant itself) are evaluated
    exactly against EVERY body, restricted to pairs the near window does
    NOT cover (chebyshev finest-cell distance > ring) so no pair is
    double-counted, with the gravity channel zeroed (the far field already
    accounts for non-near pairs at its documented error level, and the
    reference EXCLUDES gravity on overlapping pairs anyway). Both pair
    sides are produced: pass 1 gives every body its channels from giant
    partners (death under a heavier giant included), pass 2 gives each
    giant its channels from all non-giant bodies (giant-giant pairs ride
    pass 1). Cost is O(N * n_giants) collision tests — at the 4M galaxy
    with B=1024 that is ~0.1% of one exact step.

    Residual approximation: uncovered overlaps where NEITHER body ranks in
    the top ``n_giants`` (bounded by twice the (B+1)-th largest radius;
    ``bh_health`` reports the count of coverage-exceeding bodies beyond
    the giant list). Returns full-length [n] accumulators (identity rows
    for untouched bodies); ``mode="none"`` or ``n_giants=0`` contributes
    nothing and should be skipped by the caller.

    ``cell_range=(base, count)`` (traced base, static count) restricts the
    OUTPUT rows to bodies whose finest cell falls in that contiguous cell
    slice — the sharded-bh hook: the giant set (a global top_k of the
    all-gathered state, identical on every shard) is evaluated by every
    shard, but each body's rows are produced only by its CELL-owner shard,
    preserving the one-shard-per-body invariant the psum_scatter merge
    sums over (sharding/bh.py)."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    g = 1 << levels
    alive = mass > 0
    _, csz = _cell_sizes(ext, g)
    cell_min = csz[0]
    for s in csz[1:]:
        cell_min = jnp.minimum(cell_min, s)
    thr = 0.5 * ring * cell_min
    B = max(8, min(n_giants, n))
    key = jnp.where(alive & (radius > thr), radius, -1.0)
    _, topi = lax.top_k(key, B)
    gmask = key[topi] > 0
    pg, vg = pos[topi], vel[topi]
    mg = jnp.where(gmask, mass[topi], 0.0)   # masked slots: dead -> no pairs
    rg = radius[topi]
    gids = topi.astype(jnp.int32)
    cells = jnp.stack(_cells(pos, ext, g), axis=-1)      # [n, dim] i32
    gcells = cells[topi]
    is_giant = jnp.zeros((n,), bool).at[
        jnp.where(gmask, topi, n)].set(True, mode="drop")
    if cell_range is not None:
        # ownership gates OUTPUT ROWS only — the giant PARTNER set stays
        # global (an owned body must still be eaten by a non-owned giant;
        # that giant's own row is produced by ITS owner shard)
        flat = _flatten_cells(tuple(cells[:, d] for d in range(dim)), g)
        owned = (flat >= cell_range[0]) & (flat < cell_range[0]
                                           + cell_range[1])
        gmask_out = gmask & owned[topi]
    else:
        owned = None
        gmask_out = gmask

    def uncovered(ci, cj):
        """[C, M] pairs beyond the near window (any-axis distance > ring)."""
        d = jnp.abs(ci[:, None, :] - cj[None, :, :])
        return jnp.max(d, axis=-1) > ring

    from nbodyax.physics.pairwise import pair_accumulators_chunk
    gr = jnp.float32(growth_rate)
    eps2 = jnp.float32(0.0)      # force channel is discarded; eps moot
    c = max(8, min(n, chunk))
    nchunks = -(-n // c)
    npad = nchunks * c

    def pad(x):
        if npad == n:
            return x
        return jnp.pad(x, [(0, npad - n)] + [(0, 0)] * (x.ndim - 1))

    pos_p, vel_p, mass_p, radius_p, cells_p, isg_p = map(
        pad, (pos, vel, mass, radius, cells, is_giant))
    owned_p = pad(owned) if owned is not None else None
    idx_p = lax.broadcasted_iota(jnp.int32, (npad, 1), 0).squeeze(-1)

    # pass 1: every body (chunked over i) against the giant partner set
    def one_i(ci):
        s = ci * c

        def sl(x):
            return lax.dynamic_slice_in_dim(x, s, c)

        pm = uncovered(sl(cells_p), gcells)
        if owned_p is not None:
            pm = pm & sl(owned_p)[:, None]
        return pair_accumulators_chunk(
            sl(pos_p), sl(vel_p), sl(mass_p), sl(radius_p), sl(idx_p),
            pg, vg, mg, rg, gids, eps2=eps2, growth_rate=gr, mode=mode,
            pair_mask=pm, with_force=False)

    if nchunks == 1:
        acc1 = jax.tree.map(lambda x: x[None], one_i(0))
    else:
        acc1 = lax.map(one_i, jnp.arange(nchunks))
    acc1 = jax.tree.map(lambda x: x.reshape((npad,) + x.shape[2:])[:n], acc1)

    # pass 2: the giants (one i chunk of B) against every NON-giant body,
    # chunked over j; j-partials fold through the accumulator monoid
    def one_j(cj):
        s = cj * c

        def sl(x):
            return lax.dynamic_slice_in_dim(x, s, c)

        pm = uncovered(gcells, sl(cells_p)) & ~sl(isg_p)[None, :]
        return pair_accumulators_chunk(
            pg, vg, jnp.where(gmask_out, mg, 0.0), rg, gids,
            sl(pos_p), sl(vel_p), sl(mass_p), sl(radius_p), sl(idx_p),
            eps2=eps2, growth_rate=gr, mode=mode, pair_mask=pm,
            with_force=False)

    if nchunks == 1:
        acc2 = one_j(0)
    else:
        stacked = lax.map(one_j, jnp.arange(nchunks))

        def fold(k, cur):
            return combine_accumulators(
                cur, jax.tree.map(lambda x: x[k], stacked))

        acc2 = lax.fori_loop(1, nchunks, fold,
                             jax.tree.map(lambda x: x[0], stacked))

    # scatter the giant rows into full-length identity accumulators
    # (top_k indices are unique; masked slots target n -> dropped)
    ids = lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    full2 = empty_accumulators(ids, dim=dim)
    safe = jnp.where(gmask_out, topi, n)
    full2 = PairAccumulators(*[
        f.at[safe].set(v, mode="drop") for f, v in zip(full2, acc2)])
    return combine_accumulators(acc1, full2)


def _bh_cells_eval(pos, vel, mass, radius, *, eps2, growth_rate, mode,
                   levels, ring, neighbor_k, order, chunk,
                   shard=None, nshards: int = 1,
                   ci_cap: int = 0, far: str = "fmm",
                   near: str = "rows",
                   comp_cap: int = 0,
                   n_giants: int = 0) -> PairAccumulators:
    """Near+far per-cell evaluation over the full body set (or, with
    ``shard``/``nshards``, over one contiguous 1/nshards cell slice plus
    1/nshards of the completion list — every body's accumulators are then
    computed entirely by the one shard owning its finest cell, and bodies
    outside the slice keep identity accumulators).

    ``far``: "fmm" (default) evaluates the far field with dense local
    expansions (_fmm_far_force — zero window gathers, exact per-body
    coverage with no slot caps); "direct" keeps the gathered per-cell
    window pass + per-body completion (_far_force_cells/_far_force)."""
    pos, vel, mass, radius = map(jnp.asarray, (pos, vel, mass, radius))
    n = pos.shape[0]
    dim = pos.shape[-1]
    alive = mass > 0
    ext = _extent(pos, alive)
    g = 1 << levels
    ncells = g ** dim
    structure = _partner_structure(pos, vel, mass, radius, ext, g,
                                   mode == "elastic")
    order_idx, s_cell, starts, _, _ = structure
    c = min(chunk, n)
    cap = ci_cap or slot_cap(n, ncells)

    if nshards > 1:
        if ncells % nshards:
            raise ValueError(
                f"shards ({nshards}) must divide the finest grid's "
                f"{ncells} cells — use a power-of-two shard count or "
                f"raise bhLevels")
        comp_len = -(-_completion_cap(n, comp_cap) // nshards)
        cell_range = (shard * (ncells // nshards), ncells // nshards)
        comp_range = (shard * comp_len, comp_len, comp_len * nshards)
    else:
        cell_range = comp_range = None

    # the slot grid is shared between the near pass and the annulus's
    # i-side (its gather is the single most expensive build op at large N)
    fslot = None
    if near == "slots":
        fslot = _build_slot_grid(structure[4], starts, structure[3],
                                 n, ncells, max(neighbor_k, cap))

    far_slot_lanes = None
    if far == "fmm":
        # Hybrid FMM: local expansions with interaction lists at ring+1
        # (good opening ratio -> ~1e-3 truncation there), plus the
        # exact-target annulus pass for the ring < |delta|_inf <= ring+1
        # finest-level shell (always quadrupole) — together the same
        # accuracy class as the gathered "direct" engine at this ring,
        # with zero window gathers.
        grids = _level_grids(pos, mass, ext, levels, order=2)
        packed_finest = jnp.stack(grids[levels], axis=1)
        local_tab = _fmm_local_table(pos, mass, ext, levels, ring + 1, eps2,
                                     order, grids=grids)
        aslots, _ = _annulus_force_cells(
            packed_finest, ext, levels, ring, ring + 1, eps2, 2,
            structure, ci_cap=cap, chunk=c, cell_range=cell_range,
            fslot=fslot)
        if near == "slots":
            # slot-side far field: L2P evaluated per slot (zero gathers —
            # local rows are cell-major) + the annulus slots, appended to
            # the near pass's packed lanes so ONE unsort gather carries
            # near AND far. Replaces the per-body L2P row gather, the
            # annulus's own unsort gather and the over_body keep-mask
            # scatter. Overflow bodies take
            # their whole far field from the completion pass, as before.
            ncells_eval = ncells if cell_range is None else cell_range[1]
            cell0 = None if cell_range is None else cell_range[0]
            lt = (local_tab if cell0 is None else lax.dynamic_slice_in_dim(
                local_tab, cell0, ncells_eval))
            fs = (fslot if cell0 is None else lax.dynamic_slice_in_dim(
                fslot, cell0, ncells_eval))
            l2p_sl = _l2p_slots(lt, fs[:, :cap, 0:dim], ext, levels, dim,
                                cell0=cell0)
            far_slot_lanes = (l2p_sl.reshape(ncells_eval * cap, dim)
                              + aslots)

    near_acc = _near_field_cells(pos, vel, mass, radius, ext, levels, ring,
                                 eps2, jnp.float32(growth_rate), mode,
                                 neighbor_k, ci_cap=cap, chunk=c,
                                 _structure=structure, cell_range=cell_range,
                                 comp_range=comp_range, near=near,
                                 comp_cap=comp_cap, _fslot=fslot,
                                 far_slot_lanes=far_slot_lanes)

    if far == "fmm":
        # crowded-cell overflow bodies (beyond their cell's fast-pass
        # slots) take their WHOLE far field — L2P and annulus — from the
        # completion pass below, so each body is touched by exactly one
        # shard: the owner of its finest cell for slot bodies, the owner
        # of its completion slice for overflow bodies (the invariant the
        # sharded psum_scatter merge is tested against)
        srank = (jnp.arange(n, dtype=jnp.int32)
                 - starts[jnp.clip(s_cell, 0, ncells - 1)])
        over = (srank >= cap) & (s_cell < ncells)
        if far_slot_lanes is not None:
            # slot bodies' far field already rode the near unsort; only
            # the completion bodies still need theirs
            ann = jnp.zeros((n + 1, dim), jnp.float32)
        else:
            far_all = _l2p(local_tab, pos, ext, levels, dim)
            over_body = jnp.zeros((n,), bool).at[order_idx].set(over)
            keep = alive & ~over_body
            if cell_range is not None:
                # dead bodies sit in the out-of-grid bucket ncells,
                # outside every shard's cell range
                cell = jnp.where(
                    alive, _flatten_cells(_cells(pos, ext, g), g), ncells)
                keep = keep & (cell >= cell_range[0]) & (
                    cell < cell_range[0] + cell_range[1])
            # gather-based unsort (same slot arithmetic as the near pass)
            a_valid, a_idx = _slot_unsort_idx(pos, mass, ext, g, order_idx,
                                              starts, s_cell, ncells, cap,
                                              cell_range, aslots.shape[0])
            ann = jnp.pad(jnp.where(
                a_valid[:, None],
                jnp.pad(aslots, ((0, 1), (0, 0)))[a_idx], 0.0),
                ((0, 1), (0, 0)))
            ann = ann.at[:n].add(jnp.where(keep[:, None], far_all, 0.0))

        def run_ann_completion(av, psx):
            gi = order_idx[jnp.clip(psx, 0, n - 1)]
            osidx = jnp.where(psx < n, gi, n)
            af = (_annulus_force_bodies(pos[gi], packed_finest, ext, levels,
                                        ring, ring + 1, eps2, 2)
                  + _l2p(local_tab, pos[gi], ext, levels, dim))
            return av.at[osidx].set(af)

        ann = _tiered_completion(over, n, comp_range, comp_cap,
                                 run_ann_completion, ann)[:n]
        far_v = ann
    else:
        # "direct": gathered per-cell window pass + per-body completion.
        # Build the level grids ONCE here and thread them through: the
        # completion closure runs inside _tiered's lax.cond, where XLA
        # cannot CSE a rebuild against the copy outside the conditional.
        d_grids = _level_grids(pos, mass, ext, levels, order)
        fslots, fsidx = _far_force_cells(pos, mass, ext, levels, ring, eps2,
                                         order, structure, ci_cap=cap,
                                         chunk=c, cell_range=cell_range,
                                         grids=d_grids)
        far_v = jnp.zeros((n + 1, dim), jnp.float32).at[fsidx].set(fslots)
        srank = (jnp.arange(n, dtype=jnp.int32)
                 - starts[jnp.clip(s_cell, 0, ncells - 1)])
        over = (srank >= cap) & (s_cell < ncells)

        def run_far_completion(fv, psx):
            gi = order_idx[jnp.clip(psx, 0, n - 1)]
            osidx = jnp.where(psx < n, gi, n)
            far_over = _far_force(pos[gi], pos, mass, ext, levels, ring,
                                  eps2, min(psx.shape[0], c), order,
                                  grids=d_grids)
            return fv.at[osidx].set(far_over)

        # same tiered static-budget elision as the near completion
        far_v = _tiered_completion(over, n, comp_range, comp_cap,
                                   run_far_completion, far_v)[:n]

    ids = jnp.arange(n, dtype=jnp.int32)
    far_acc = empty_accumulators(ids, dim=dim)._replace(
        force=jnp.where(alive[:, None], far_v, 0.0))
    out = combine_accumulators(near_acc, far_acc)
    if n_giants and mode != "none":
        # exact any-distance collisions for the largest-radius bodies
        # (giant_collision_accumulators docstring). Sharded: every shard
        # evaluates the identical global giant set but produces rows only
        # for its own cell slice (cell_range), preserving the
        # one-shard-per-body invariant the psum_scatter merge sums over.
        out = combine_accumulators(out, giant_collision_accumulators(
            pos, vel, mass, radius, ext=ext, levels=levels, ring=ring,
            growth_rate=growth_rate, mode=mode, n_giants=n_giants,
            chunk=max(chunk, 4096), cell_range=cell_range))
    return out


def bh_accumulators(pos, vel, mass, radius, *, eps: float = 0.0,
                    growth_rate: float = 0.1, mode: str = "reference",
                    levels: int = 0, ring: int = 1, neighbor_k: int = 64,
                    order: int = 2, chunk: int = 8192,
                    ci_cap: int = 0, far: str = "fmm",
                    near: str = "rows",
                    comp_cap: int = 0,
                    n_giants: int = 1024) -> PairAccumulators:
    """Drop-in accum_fn (same interface as pair_accumulators): approximate
    far-field force + exact near-field force/collision accumulators, plus
    exact any-distance collisions for the ``n_giants`` largest-radius
    bodies (giant_collision_accumulators; 0 disables).

    The near field runs as a per-CELL pass (shared window gathers) over
    each cell's first slot_cap(n, cells) sorted bodies (2x the average
    occupancy, floor 32), with a per-body completion pass for the (rare,
    _completion_cap-bounded) bodies beyond that. The far field uses the
    ``far`` engine (module docstring): "fmm" (default, dense local
    expansions + exact-target annulus, zero window gathers) or "direct"
    (gathered per-cell windows)."""
    dim = pos.shape[-1]
    levels = levels or auto_levels(pos.shape[0], dim=dim)
    neighbor_k = neighbor_k or auto_neighbor_k(pos.shape[0], levels, ring,
                                               dim, near)
    return _bh_cells_eval(pos, vel, mass, radius,
                          eps2=jnp.float32(eps) ** 2,
                          growth_rate=growth_rate, mode=mode, levels=levels,
                          ring=ring, neighbor_k=neighbor_k, order=order,
                          chunk=chunk, ci_cap=ci_cap, far=far, near=near,
                          comp_cap=comp_cap, n_giants=n_giants)


def bh_cellrange_accumulators(pos, vel, mass, radius, shard, nshards: int, *,
                              eps: float = 0.0, growth_rate: float = 0.1,
                              mode: str = "reference", levels: int = 0,
                              ring: int = 1, neighbor_k: int = 64,
                              order: int = 2, chunk: int = 8192,
                              far: str = "fmm",
                              near: str = "rows",
                              comp_cap: int = 0,
                              n_giants: int = 1024) -> PairAccumulators:
    """One cell-range shard's contribution to the global accumulators.

    Full-length [n] accumulators holding real values only for bodies whose
    finest cell falls in shard ``shard``'s contiguous 1/nshards cell slice
    (identity elsewhere) — the sharded-bh building block: every shard calls
    this on the identical all-gathered state with its own ``shard`` index,
    and because the slices are disjoint the cross-shard merge degenerates
    from the accumulator monoid to a plain sum of identity-rebased lanes
    (see sharding/bh.py), which rides a single psum_scatter."""
    dim = pos.shape[-1]
    levels = levels or auto_levels(pos.shape[0], dim=dim)
    neighbor_k = neighbor_k or auto_neighbor_k(pos.shape[0], levels, ring,
                                               dim, near)
    return _bh_cells_eval(pos, vel, mass, radius,
                          eps2=jnp.float32(eps) ** 2,
                          growth_rate=growth_rate, mode=mode, levels=levels,
                          ring=ring, neighbor_k=neighbor_k, order=order,
                          chunk=chunk, shard=shard, nshards=nshards, far=far,
                          near=near, comp_cap=comp_cap, n_giants=n_giants)


@partial(jax.jit, static_argnames=("levels", "neighbor_k", "ring", "near",
                                   "comp_cap"))
def overflow_count(pos, mass, *, levels: int = 0, neighbor_k: int = 0,
                   ring: int = 1, near: str = "rows", comp_cap: int = 0):
    """Diagnostic: how many live bodies are invisible to some part of the
    near field. Two terms:

    1. partner-cap overflow, per engine:
       - ``near="rows"``: bodies beyond their window ROW's ``neighbor_k``
         partner slots (the near field gathers one window per row of
         (2*ring+1) consecutive cells, capped at K); counts the total
         excess over all in-grid window rows.
       - ``near="slots"``: bodies beyond their CELL's ``neighbor_k``
         partner slots (windows slice ``neighbor_k`` slot rows per window
         cell); counts the total excess over all cells.
       Either way the excess bodies are invisible AS PARTNERS to every
       body whose window covers them.
    2. completion-budget overflow: bodies beyond both their cell's
       slot_cap(n, cells) fast-pass slots and the _completion_cap(n)
       per-body completion budget
       (those get NO near field — and no far field — of their own).

    0 means the near field is exact for the current distribution."""
    k_over, dropped = _overflow_terms(pos, mass, levels=levels,
                                      neighbor_k=neighbor_k, ring=ring,
                                      near=near, comp_cap=comp_cap)
    return k_over + dropped


def _occupancy(pos, mass, levels, ring, near, comp_cap=0):
    """Shared overflow/cap-probe plumbing: (per-cap-unit occupancy,
    i-slot overflow total, completion-budget drop). The first is per CELL
    for the slots engine, per (2*ring+1)-cell window ROW for rows — the
    unit ``neighbor_k`` caps in each engine. The second is the total body
    count past the fast passes' per-cell slot_cap — the completion-pass
    population a count-aware ``bhCompCap`` must cover."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    g = 1 << levels
    alive = mass > 0
    ext = _extent(pos, alive)
    cell = jnp.where(alive, _flatten_cells(_cells(pos, ext, g), g), g ** dim)
    occ = jnp.zeros((g ** dim + 1,), jnp.int32).at[cell].add(1)
    if near == "slots":
        unit = occ[:-1]
    else:
        occg = occ[:-1].reshape((g,) * dim)  # row-major, x the LAST axis
        # window-row occupancy at each center x: sum of the (2*ring+1)
        # consecutive cells, zero outside the grid (matches the clamps)
        occp = jnp.pad(occg, [(0, 0)] * (dim - 1) + [(ring, ring)])
        unit = sum(occp[..., d:d + g] for d in range(2 * ring + 1))
    i_over = jnp.sum(jnp.maximum(occ[:-1] - slot_cap(n, g ** dim), 0))
    dropped = jnp.maximum(i_over - _completion_cap(n, comp_cap), 0)
    return unit, i_over, dropped


def _overflow_terms(pos, mass, *, levels, neighbor_k, ring, near,
                    comp_cap=0):
    """(partner-cap overflow, completion-budget overflow) — the two terms of
    ``overflow_count``, separated so the driver's bhAdapt can tell which
    knob would actually help (K widening fixes only the first)."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    levels = levels or auto_levels(n, dim=dim)
    neighbor_k = neighbor_k or auto_neighbor_k(n, levels, ring, dim, near)
    unit, _, dropped = _occupancy(pos, mass, levels, ring, near, comp_cap)
    if near == "slots":
        # the slot grid exposes max(k, slot_cap) partner slots per cell
        # (it is sized to carry the i-slot slice too), so that is the cap
        # bodies actually overflow — counting against a pinned smaller k
        # would report overflow the engine covers
        neighbor_k = max(neighbor_k, slot_cap(n, (1 << levels) ** dim))
    k_over = jnp.sum(jnp.maximum(unit - neighbor_k, 0))
    return k_over, dropped


@partial(jax.jit, static_argnames=("levels", "ring", "near", "comp_cap"))
def needed_neighbor_k(pos, mass, *, levels: int, ring: int = 1,
                      near: str = "rows", comp_cap: int = 0):
    """Count-aware minimal caps: [smallest ``neighbor_k`` with ZERO
    partner-cap overflow for this state (max per-cell occupancy for slots,
    max per-window-row occupancy for rows), completion-budget drop at the
    current grid, total completion-pass population (bodies past the fast
    passes' slot_cap — the smallest ``bhCompCap`` with zero drop)]. One
    dispatch; ``pick_levels`` and the driver's bhAdapt use it to widen K
    and the completion budget exactly instead of blind doubling."""
    unit, i_over, dropped = _occupancy(pos, mass, levels, ring, near,
                                       comp_cap)
    return jnp.stack([jnp.max(unit), dropped, i_over])


@partial(jax.jit, static_argnames=("levels", "neighbor_k", "ring", "near",
                                   "comp_cap", "n_giants"))
def bh_health(pos, mass, radius, *, levels: int, neighbor_k: int = 0,
              ring: int = 1, near: str = "rows", comp_cap: int = 0,
              n_giants: int = 0):
    """One-dispatch health probe for the driver's per-log bh check:
    [partner-cap overflow, completion-budget overflow, max live radius,
    min bounding-box span, count-aware minimal partner cap, completion-pass
    population, giant-list excess]. The driver fetches this single vector
    and (with ``bhAdapt``) widens bhNeighborK to the reported minimal cap
    on partner-cap overflow, refines bhLevels on completion-budget overflow
    (K does not touch that term) or — at the level cap — widens bhCompCap
    to the reported population, or (only with ``bhGiants=0``) coarsens
    bhLevels when 2*max_radius outgrows the ring's collision coverage
    (ring * min_span / 2^levels). The last term is the number of
    coverage-exceeding bodies (radius > ring*cell/2) beyond the
    ``n_giants`` exact-collision list — the population whose distant
    overlaps remain approximation 1 (giant_collision_accumulators)."""
    alive = mass > 0
    k_over, dropped = _overflow_terms(pos, mass, levels=levels,
                                      neighbor_k=neighbor_k, ring=ring,
                                      near=near, comp_cap=comp_cap)
    unit, i_over, _ = _occupancy(pos, mass, levels, ring, near, comp_cap)
    rmax = jnp.max(jnp.where(alive, radius, 0.0))
    _, spans = _extent(pos, alive)
    span_min = spans[0]
    for s in spans[1:]:
        span_min = jnp.minimum(span_min, s)
    thr = 0.5 * ring * span_min / (1 << levels)
    giant_excess = jnp.maximum(
        0, jnp.sum(alive & (radius > thr)) - n_giants)
    return jnp.stack([k_over.astype(jnp.float32),
                      dropped.astype(jnp.float32), rmax, span_min,
                      jnp.max(unit).astype(jnp.float32),
                      i_over.astype(jnp.float32),
                      giant_excess.astype(jnp.float32)])
