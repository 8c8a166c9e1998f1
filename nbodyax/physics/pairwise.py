"""Dense all-pairs accumulators (jnp backend + behavioral oracle).

This module is the executable spec of the reference's ``ComputeForces``
megakernel (``/root/reference/src/nbody.cu:139-271``): for every body i it
reduces, over all other bodies j, the gravity partial force and the collision
bookkeeping. It deliberately reproduces the reference's per-pair *semantics*
(SURVEY.md section 3.2/3.5):

- overlap test ``d^2 <= (r_i + r_j)^2`` (nbody.cu:126-134);
- overlapping pairs are excluded from the force sum (the ``continue``s at
  nbody.cu:221,226);
- reference merge rule: if overlap and ``m_i >= m_j`` the i body gains ``m_j``
  mass and ``r_j * growthRate`` radius (nbody.cu:215-221); if ``m_i < m_j`` the
  i body is marked dead (nbody.cu:222-226). With equal masses both bodies
  absorb each other and neither dies — quirk Q1, reproduced verbatim;
- un-normalized force kernel ``(p_j - p_i) * m_j / d^3`` — magnitude m/d^2
  (nbody.cu:230-239), optionally softened to ``m / (d^2 + eps^2)^{3/2}``
  (eps=0 restores the reference's bare kernel, quirk Q4).

It does NOT reproduce the launch-geometry bugs Q2 (mod-129 tail) and Q3
(floor-division dropped bodies) — those are artifacts of the reference's grid
math, not of its physics (SURVEY.md section 3.5).

All pair math is chunked over i so peak memory is O(chunk * N), computed with
``lax.map`` so the compiled program is a loop, not an unrolled graph.

Every reduction here is associative over the j set, so partial accumulators
from disjoint j sets combine exactly — this is what lets the same semantics
ride the cross-shard ring (sharding/ring.py) and the kernel's j-tile loop
(physics/kernels.py). Combination rules: force/gained_* add, died ORs,
(best_mass, parent) max-reduces with lowest-index tie-break, dv adds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["PairAccumulators", "pair_accumulators", "pair_accumulators_chunk",
           "combine_accumulators", "empty_accumulators"]

# f32 reductions stay f32: a GPU may otherwise run an f32 einsum in TF32
_EXACT = lax.Precision.HIGHEST


class PairAccumulators(NamedTuple):
    """Per-body reductions over a set of partner bodies (per-i arrays).
    D is the spatial dimensionality (2 for the reference; 3 supported as a
    framework extension — all pair math here is shape-generic).

    force:         f32[C,D] un-normalized gravity sum (pre G scaling)
    gained_mass:   f32[C]   reference-mode absorbed mass   (nbody.cu:218)
    gained_radius: f32[C]   reference-mode absorbed radius (nbody.cu:219,
                            growth rate already applied)
    died:          bool[C]  reference-mode "a heavier body overlaps me"
                            (nbody.cu:222-226)
    best_mass:     f32[C]   momentum-mode: mass of the strongest overlapping
                            body that beats i (-inf when none)
    parent:        i32[C]   momentum-mode: global index of that body, else i
    dv:            f32[C,D] elastic-mode accumulated impulse velocity change
    """

    force: jax.Array
    gained_mass: jax.Array
    gained_radius: jax.Array
    died: jax.Array
    best_mass: jax.Array
    parent: jax.Array
    dv: jax.Array


def empty_accumulators(ii: jax.Array, dim: int = 2) -> PairAccumulators:
    """Identity element of the accumulator monoid for i bodies ``ii``."""
    c = ii.shape[0]
    zd = jnp.zeros((c, dim), jnp.float32)
    z1 = jnp.zeros((c,), jnp.float32)
    return PairAccumulators(
        force=zd, gained_mass=z1, gained_radius=z1,
        died=jnp.zeros((c,), bool),
        best_mass=jnp.full((c,), -jnp.inf, jnp.float32),
        parent=ii.astype(jnp.int32), dv=zd)


def combine_accumulators(a: PairAccumulators, b: PairAccumulators) -> PairAccumulators:
    """Fold partial accumulators from two disjoint j sets (associative)."""
    b_wins = (b.best_mass > a.best_mass) | (
        (b.best_mass == a.best_mass) & (b.parent < a.parent))
    return PairAccumulators(
        force=a.force + b.force,
        gained_mass=a.gained_mass + b.gained_mass,
        gained_radius=a.gained_radius + b.gained_radius,
        died=a.died | b.died,
        best_mass=jnp.maximum(a.best_mass, b.best_mass),
        parent=jnp.where(b_wins, b.parent, a.parent),
        dv=a.dv + b.dv)


def pair_accumulators_chunk(pi, vi, mi, ri, ii, pos, vel, mass, radius, jj, *,
                            eps2, growth_rate, mode: str,
                            pair_mask=None,
                            with_force: bool = True) -> PairAccumulators:
    """Accumulators for an i-chunk [C] against a j set [M].

    ``ii``/``jj`` are *global* body indices (self-pairs are skipped by global
    index equality, the analog of the reference's ``skip`` logic at
    nbody.cu:200-204). Building block for both the chunked dense pass below and
    the cross-shard ring (sharding/ring.py), where each hop folds one remote
    j-tile into the local i accumulators — mirroring how the reference
    accumulates across shared-memory tiles (nbody.cu:182-242).

    ``pair_mask`` (optional bool [C, M]) restricts the evaluation to a pair
    subset — ANDed into the validity gate, so masked-out pairs contribute
    exact identity to every channel. ``with_force=False`` skips the gravity
    reduction entirely (force comes back zero). Both are used by the
    Barnes-Hut giant-body pass (barneshut.giant_collision_accumulators),
    which evaluates only COLLISION channels of the pairs the near window
    does NOT cover.
    """
    alive_j = (mass > 0)[None, :]
    alive_i = (mi > 0)[:, None]
    jdx = jj[None, :]

    dp = pos[None, :, :] - pi[:, None, :]              # p_j - p_i  [C,M,2]
    d2 = jnp.sum(dp * dp, axis=-1)                     # [C,M]
    rsum = ri[:, None] + radius[None, :]
    overlap = d2 <= rsum * rsum                        # nbody.cu:133
    valid = alive_i & alive_j & (ii[:, None] != jdx)
    if pair_mask is not None:
        valid &= pair_mask
    overlap &= valid

    # Gravity: excluded on overlapping pairs (reference continue, nbody.cu:221,226).
    # In elastic mode bodies never merge, so gravity applies to every valid pair
    # (softening recommended) while the bounce impulse handles the contact.
    out = empty_accumulators(ii, dim=pi.shape[-1])
    if with_force:
        if mode == "elastic":
            fmask = valid
        else:
            fmask = valid & ~overlap
        d2_eff = d2 + eps2
        safe = fmask & (d2_eff > 0)
        inv = lax.rsqrt(jnp.where(safe, d2_eff, 1.0))
        w = jnp.where(safe, mass[None, :] * (inv * inv * inv),
                      0.0)  # m_j / d_eff^3
        out = out._replace(force=jnp.einsum("cn,cnd->cd", w, dp,
                                            precision=_EXACT))

    if mode == "reference":
        heavier = mi[:, None] >= mass[None, :]         # nbody.cu:215 (>= : Q1)
        merge = overlap & heavier
        out = out._replace(
            gained_mass=jnp.sum(jnp.where(merge, mass[None, :], 0.0), axis=1),
            gained_radius=jnp.sum(
                jnp.where(merge, radius[None, :] * growth_rate, 0.0), axis=1),
            died=jnp.any(overlap & ~heavier, axis=1))
    elif mode == "momentum":
        # j "beats" i if heavier, or equal mass and lower global index.
        beats = (mass[None, :] > mi[:, None]) | (
            (mass[None, :] == mi[:, None]) & (jdx < ii[:, None]))
        cand = overlap & beats
        key = jnp.where(cand, mass[None, :], -jnp.inf)
        # prefer larger mass, then lower global index
        is_best = cand & (key == jnp.max(key, axis=1, keepdims=True))
        order = jnp.where(is_best, -jdx, jnp.iinfo(jnp.int32).min)
        best_local = jnp.argmax(order, axis=1)
        any_cand = jnp.any(cand, axis=1)
        out = out._replace(
            best_mass=jnp.where(any_cand, jnp.max(key, axis=1), -jnp.inf),
            parent=jnp.where(any_cand, jj[best_local], ii).astype(jnp.int32))
    elif mode == "elastic":
        rel = vel[None, :, :] - vi[:, None, :]          # v_j - v_i
        vdotp = jnp.sum(rel * dp, axis=-1)
        approaching = overlap & (vdotp < 0) & (d2 > 0)
        msum = mi[:, None] + mass[None, :]
        # double-where: a dead-dead pair has msum == 0; its lane is masked
        # (approaching is False there) so the VALUE is 0 either way, but
        # jax.grad through where(mask, 0/0, 0) is NaN unless the masked
        # branch is finite — guard the denominator like d2 below
        msum = jnp.where(msum > 0, msum, 1.0)
        coef = jnp.where(approaching,
                         2.0 * mass[None, :] / msum * vdotp
                         / jnp.where(d2 > 0, d2, 1.0),
                         0.0)
        out = out._replace(dv=jnp.einsum("cn,cnd->cd", coef, dp,
                                         precision=_EXACT))
    elif mode != "none":
        raise ValueError(f"unknown collision mode {mode!r}")

    return out


def pair_accumulators(pos, vel, mass, radius, *, eps: float = 0.0,
                      growth_rate: float = 0.1, mode: str = "reference",
                      chunk: Optional[int] = None) -> PairAccumulators:
    """All-pairs accumulators, chunked over i bodies.

    ``chunk`` bounds the [chunk, N] pair temporaries; it is auto-sized so that
    chunk * N is roughly 2^22 elements (~16 MB f32 per temporary).
    """
    n = pos.shape[0]
    if chunk is None:
        chunk = max(8, min(n, (1 << 22) // max(n, 1)))
    nchunks = -(-n // chunk)
    npad = nchunks * chunk
    eps2 = jnp.float32(eps) * jnp.float32(eps)
    growth_rate = jnp.float32(growth_rate)

    def pad(x):
        if npad == n:
            return x
        w = [(0, npad - n)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, w)

    pos_p, vel_p = pad(pos), pad(vel)
    mass_p, radius_p = pad(mass), pad(radius)  # padded slots: mass 0 => dead
    idx = lax.broadcasted_iota(jnp.int32, (npad, 1), 0).squeeze(-1)
    jj = idx[:n]

    def one_chunk(c):
        s = c * chunk
        args = [lax.dynamic_slice_in_dim(x, s, chunk)
                for x in (pos_p, vel_p, mass_p, radius_p, idx)]
        return pair_accumulators_chunk(
            *args, pos, vel, mass, radius, jj,
            eps2=eps2, growth_rate=growth_rate, mode=mode)

    if nchunks == 1:
        out = jax.tree.map(lambda x: x[None], one_chunk(0))
    else:
        out = lax.map(one_chunk, jnp.arange(nchunks))
    return jax.tree.map(lambda x: x.reshape((npad,) + x.shape[2:])[:n], out)
