"""Pallas GPU kernel: fused all-pairs gravity + collision pass.

The reference's ``ComputeForces`` CUDA kernel (its src/nbody.cu:139-271)
runs one thread per body in 128-thread blocks, stages 128-body
j-tiles cooperatively in shared memory and runs the overlap test, the merge
bookkeeping and the force sum over each tile in registers (SURVEY.md
section 2.1). This kernel keeps that dataflow on Pallas' Triton route:

- each program owns one i-block of ``tile_i`` bodies; its features stay in
  registers for the whole sweep, and so do its accumulators, one
  ``[tile_i, tile_j]`` tile per channel (each pair lane sums its own
  partners; the cross-lane reductions run once, after the sweep);
- a ``lax.fori_loop`` streams ``tile_j``-wide j-tiles from the full j
  feature array, and Triton pipelines those loads over ``num_stages`` — the
  reference's shared-memory tile sweep, minus its mod-129 tail bug (Q2) and
  dropped-tail-bodies bug (Q3);
- each i-block writes its channels once. Programs share nothing, so the
  order in which the GPU runs them does not matter;
- past ``MAX_LANE_TERMS * tile_j`` j columns the j array is cut into equal
  spans, one program per (i-block, span), and the wrapper combines the
  spans' channels. That bounds the f32 sum each pair lane carries, and with
  it the force error, at any N.

The default tiles and warps were swept on an H100 (PERF.md).

The per-pair semantics (overlap test, merge bookkeeping, force kernel,
self-skip) are exactly those of physics/pairwise.py — the oracle this kernel
is tested against. Why not the tensor cores' ||a-b||^2 expansion: positions
span the field (~1e5) while collision distances are ~1e2, so d^2 =
|pi|^2+|pj|^2-2pi.pj in f32 (let alone TF32) loses ~eps*|p|^2 ~ 6e2
absolute and corrupts the overlap test. The subtract-first form (dx = xj -
xi exact, then dx^2+dy^2) keeps full f32 accuracy; the work is ~22 f32
operations and one ``rsqrt`` per pair, on the CUDA cores.

The kernel is dimension-generic (``dim`` static argument, 2 or 3; the
reference is 2-D, 3-D is a framework extension). Feature layout for D
dimensions (NUM_FEATS = 8 fits both): pos[0:D], vel[D:2D], mass at 2D,
radius at 2D+1, zero padding to 8.

Accumulator channel layout (one f32[N, 8] array, positions a function of D):
  ch[0:D]   force components                  (all modes; additive)
  ch[D]     gained_mass | dvx/2               (reference | elastic; additive)
  ch[D+1]   gained_radius | dvy/2             (reference | elastic; additive)
  ch[D+2]   died_count | dvz/2 (D=3)          (reference; additive, decoded
                                               as >0 | elastic; additive)
  ch6       best_mass                         (momentum; max-combined; stays
                                               _NEG_INF iff no candidate)
  remaining channels unused (zero; channels [0:6] are additive in every mode)

Momentum mode also emits an i32[N] parent id (lowest global id among the
heaviest candidates), exact at any N an i32 can index.

Reverse mode: a ``jax.custom_vjp`` takes the VJP of ``raw_reference`` — the
same raw channels computed with the oracle's jnp pair math — so gradients
through this kernel are those of ``jax.grad`` of the oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from nbodyax.physics.pairwise import (PairAccumulators,
                                      pair_accumulators_chunk)

__all__ = ["pallas_pair_accumulators", "tile_accumulators_raw",
           "raw_reference", "body_features", "decode_raw",
           "DEFAULT_TILE_I", "DEFAULT_TILE_J"]

NUM_FEATS = 8   # x, y, vx, vy, mass, radius, pad, pad
NUM_CH = 8
DEFAULT_TILE_I = 8
DEFAULT_TILE_J = 128
# Most terms one pair lane sums in sequence; a j span holds this many
# tiles. The force error grows about linearly with it: on an H100 a lane of
# 8,192 terms (N=1M, 128-wide tiles) read 3.1e-6 of the oracle's maximum
# force, and one of 32,768 (N=1M, 32-wide tiles) 1.2e-5, over the 1e-5 gate
# (PERF.md)
MAX_LANE_TERMS = 8192
NUM_STAGES = 2
_NEG_INF = float(np.finfo(np.float32).min)  # sentinel for "no candidate"
_I32_MAX = int(np.iinfo(np.int32).max)      # sentinel parent: no candidate


def body_features(pos, vel, mass, radius) -> jax.Array:
    """Pack state into the kernel's [N, NUM_FEATS] feature layout
    (pos[0:D], vel[D:2D], mass, radius, zero padding; D = pos.shape[-1]).

    Dead bodies (mass <= 0) get radius 0 here. With that, every inner-loop
    contribution of a dead or padded j body vanishes without explicit alive
    masks — force/merge-gain/elastic all carry an m_j factor, die needs
    m_j > m_i >= 0, and the only mass-free channel (gained radius,
    nbody.cu:219) is zeroed by this clamp.
    """
    n, d = pos.shape
    z = jnp.zeros((n,), jnp.float32)
    cols = ([pos[:, k] for k in range(d)] + [vel[:, k] for k in range(d)]
            + [mass, jnp.where(mass > 0, radius, 0.0)])
    cols += [z] * (NUM_FEATS - len(cols))
    return jnp.stack(cols, axis=1)


def _pair_kernel(off_ref, xi_ref, xj_ref, out_ref, *par_ref, mode: str,
                 eps2: float, growth: float, tile_i: int, tile_j: int,
                 n_jtiles: int, dim: int):
    """One i-block against the ``n_jtiles`` j-tiles of one j span. off:
    i32[2] (global index of i row 0 and j column 0); xi: [F, TI] this
    block's feature columns; xj: [F, Nj] the whole j feature array; out:
    [NUM_CH, TI] channel rows. Momentum mode gets a second output, i32[TI]
    parent ids."""
    i_base = off_ref[0] + pl.program_id(0) * tile_i
    span0 = pl.program_id(1) * (n_jtiles * tile_j)   # first column of span
    j_off = off_ref[1]
    col = lambda f: xi_ref[f, :][:, None]                      # [TI, 1]
    pi = [col(d) for d in range(dim)]
    mi, ri = col(2 * dim), col(2 * dim + 1)
    vi = [col(dim + d) for d in range(dim)]
    i_ids = (i_base + lax.broadcasted_iota(jnp.int32, (tile_i,), 0))[:, None]
    lane = lax.broadcasted_iota(jnp.int32, (tile_j,), 0)

    # Accumulators are [TI, TJ] tiles: each pair lane keeps its own partial
    # sums across the sweep, so the loop body is elementwise and the
    # cross-lane reductions run once per i-block, after the loop.
    n_add = dim + {"reference": 3, "elastic": dim}.get(mode, 0)
    carry = [jnp.zeros((tile_i, tile_j), jnp.float32)] * n_add
    if mode == "momentum":
        carry += [jnp.full((tile_i, tile_j), _NEG_INF, jnp.float32),
                  jnp.full((tile_i, tile_j), _I32_MAX, jnp.int32)]

    def body(t, carry):
        j0 = pl.multiple_of(span0 + t * tile_j, tile_j)
        row = lambda f: xj_ref[f, pl.ds(j0, tile_j)][None, :]  # [1, TJ]
        dp = [row(d) - a for d, a in enumerate(pi)]            # p_j - p_i
        d2 = dp[0] * dp[0]
        for c in dp[1:]:
            d2 = d2 + c * c
        mj, rj = row(2 * dim), row(2 * dim + 1)
        rsum = ri + rj
        # overlap_raw includes self-pairs (d2=0 <= rsum^2) and any overlap
        # with a dead body (dead radius is clamped to 0 in body_features).
        # Both are exactly the pairs that must not contribute force, so the
        # force path needs no alive/self masks; the merge modes add a
        # not-self test, elastic gates on vdotp < 0 instead.
        overlap_raw = d2 <= rsum * rsum                        # nbody.cu:133
        inv = lax.rsqrt(d2 if eps2 == 0.0 else d2 + eps2)
        wm = mj * (inv * inv * inv)          # m_j factor zeroes dead-j pairs
        if mode != "elastic":
            w = jnp.where(overlap_raw, 0.0, wm)
        elif eps2 == 0.0:
            # gravity acts on overlapping pairs too; only the d2 = 0
            # singularities (self / exactly coincident) must be kept out
            w = jnp.where(d2 > 0, wm, 0.0)
        else:
            w = wm                           # finite everywhere, 0 at dp = 0
        out = [acc + w * c for acc, c in zip(carry[:dim], dp)]
        rest = carry[dim:]

        j_ids = (j_off + j0 + lane)[None, :]
        if mode == "reference":
            overlap = overlap_raw & (i_ids != j_ids)
            heavier = mi >= mj               # nbody.cu:215 (>=: quirk Q1)
            merge = overlap & heavier
            gm, gr, died = rest
            out += [gm + jnp.where(merge, mj, 0.0),
                    gr + jnp.where(merge, rj * growth, 0.0),
                    died + jnp.where(overlap & ~heavier, 1.0, 0.0)]
        elif mode == "momentum":
            # j beats i if heavier, or equal mass with lower global id; this
            # already excludes the self-pair (equal mass, equal id)
            best, best_j = rest
            beats = (mj > mi) | ((mj == mi) & (j_ids < i_ids))
            key = jnp.where(overlap_raw & beats, mj, _NEG_INF)
            # a lane's j ids grow with t, so on equal mass the lane keeps
            # its earlier (lower) id: strict > is the lowest-id tie-break
            win = key > best
            out += [jnp.where(win, key, best), jnp.where(win, j_ids, best_j)]
        elif mode == "elastic":
            vdotp = (row(dim) - vi[0]) * dp[0]
            for d in range(1, dim):
                vdotp = vdotp + (row(dim + d) - vi[d]) * dp[d]
            # vdotp < 0 alone excludes self-pairs and exact coincidence
            # (there dp = 0, so vdotp == 0 exactly)
            approaching = overlap_raw & (vdotp < 0)
            # m_j/(m_i+m_j) * vdotp/d2 with an exact divide; the min() clamp
            # keeps an overflowed denominator finite so the impulse degrades
            # to ~0 instead of NaN. The factor 2 is applied in decode_raw.
            md = jnp.minimum((mi + mj) * d2, jnp.float32(3.0e38))
            coef = jnp.where(approaching, vdotp * (mj / md), 0.0)
            out += [acc + coef * c for acc, c in zip(rest, dp)]
        return out

    carry = lax.fori_loop(0, n_jtiles, body, carry)

    zero = jnp.zeros((tile_i,), jnp.float32)
    chans = [jnp.sum(c, axis=1) for c in carry[:n_add]]
    chans += [zero] * (6 - len(chans))
    if mode == "momentum":
        best, best_j = carry[dim:]
        bm = jnp.max(best, axis=1)
        # lowest j id among the heaviest candidates; with none, bm stays
        # _NEG_INF and the id _I32_MAX, which decode_raw ignores
        par_ref[0][:] = jnp.min(jnp.where(best == bm[:, None], best_j,
                                          _I32_MAX), axis=1)
        chans.append(bm)
    else:
        chans.append(zero)
    chans.append(zero)
    for c, v in enumerate(chans):
        out_ref[c, :] = v


def num_warps(tile_i: int, tile_j: int) -> int:
    """Warps per program: 4 pair lanes of the [TI, TJ] tile per thread,
    between 1 and 8 warps."""
    return min(8, max(1, tile_i * tile_j // 128))


def _pad_to(x, size, axis):
    pad = size - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "eps", "growth_rate", "tile_i", "tile_j",
                     "interpret", "dim"))
def tile_accumulators_raw(feats_i, feats_j_t, i_offset, j_offset, *,
                          mode: str, eps: float, growth_rate: float,
                          tile_i: int = DEFAULT_TILE_I,
                          tile_j: int = DEFAULT_TILE_J,
                          interpret: bool = False,
                          dim: int = 2):
    """Raw channel accumulators of i bodies against j bodies.

    feats_i: f32[Ni, NUM_FEATS] (rows); feats_j_t: f32[NUM_FEATS, Nj]
    (columns). i_offset/j_offset: global index of row/column 0 (scalars;
    dynamic so ring hops don't retrace). ``dim`` must match the
    dimensionality the features were packed with (body_features; the packed
    [N, 8] layout does not encode it). Returns (f32[Ni, NUM_CH], parent)
    where parent is i32[Ni] in momentum mode and None otherwise.

    The kernel is compiled for the GPU. Anywhere else it raises, unless
    ``interpret=True`` asks for the Pallas interpreter (tests on the CPU).
    Tile sizes must be powers of two. Reverse-mode differentiable (see the
    module docstring).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Pallas pair kernel is compiled for the GPU only, and "
            f"the default backend is {jax.default_backend()!r}; pass "
            "interpret=True to run it in the Pallas interpreter")
    for t in (tile_i, tile_j):
        if t < 1 or t & (t - 1):
            raise ValueError(f"tile sizes must be powers of two, got {t}")
    return _raw(feats_i, feats_j_t,
                jnp.asarray(i_offset, jnp.int32),
                jnp.asarray(j_offset, jnp.int32),
                mode, float(eps), float(growth_rate), int(tile_i),
                int(tile_j), bool(interpret), dim)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8, 9, 10))
def _raw(feats_i, feats_j_t, i_offset, j_offset, mode, eps, growth_rate,
         tile_i, tile_j, interpret, dim):
    """custom_vjp core: the kernel sweep (primal), with the VJP of
    ``raw_reference`` as its backward."""
    return _raw_impl(feats_i, feats_j_t, i_offset, j_offset, mode, eps,
                     growth_rate, tile_i, tile_j, interpret, dim)


def _raw_fwd(feats_i, feats_j_t, i_offset, j_offset, mode, eps, growth_rate,
             tile_i, tile_j, interpret, dim):
    out = _raw_impl(feats_i, feats_j_t, i_offset, j_offset, mode, eps,
                    growth_rate, tile_i, tile_j, interpret, dim)
    return out, (feats_i, feats_j_t, i_offset, j_offset)


def _raw_bwd(mode, eps, growth_rate, tile_i, tile_j, interpret, dim,
             res, g):
    feats_i, feats_j_t, i_offset, j_offset = res
    _, vjp = jax.vjp(
        lambda fi, fjt: raw_reference(fi, fjt, i_offset, j_offset, mode=mode,
                                      eps=eps, growth_rate=growth_rate,
                                      dim=dim),
        feats_i, feats_j_t)
    d_fi, d_fjt = vjp(g[0])
    f0 = lambda x: np.zeros(np.shape(x), jax.dtypes.float0)  # int offsets
    return d_fi, d_fjt, f0(i_offset), f0(j_offset)


_raw.defvjp(_raw_fwd, _raw_bwd)


def _raw_impl(feats_i, feats_j_t, i_offset, j_offset, mode, eps, growth_rate,
              tile_i, tile_j, interpret, dim):
    ni, nj = feats_i.shape[0], feats_j_t.shape[1]
    ni_pad = -(-ni // tile_i) * tile_i
    n_iblocks = ni_pad // tile_i
    # equal j spans of at most MAX_LANE_TERMS tiles each
    n_spans = -(-nj // (MAX_LANE_TERMS * tile_j))
    span_tiles = -(-nj // (n_spans * tile_j))
    nj_pad = n_spans * span_tiles * tile_j
    # pad rows/columns: mass 0 => dead; both sides column-major so every
    # feature load is one contiguous row
    feats_i_t = _pad_to(feats_i.T, ni_pad, 1)
    feats_j_t = _pad_to(feats_j_t, nj_pad, 1)
    offsets = jnp.stack([i_offset, j_offset]).astype(jnp.int32)

    kernel = functools.partial(
        _pair_kernel, mode=mode, eps2=float(eps) ** 2,
        growth=float(np.float32(growth_rate)), tile_i=tile_i, tile_j=tile_j,
        n_jtiles=span_tiles, dim=dim)
    # span s writes channel rows [s*NUM_CH, (s+1)*NUM_CH) and parent ids
    # [s*ni_pad, (s+1)*ni_pad)
    out_specs = [pl.BlockSpec((NUM_CH, tile_i), lambda i, s: (s, i))]
    out_shape = [jax.ShapeDtypeStruct((n_spans * NUM_CH, ni_pad),
                                      jnp.float32)]
    if mode == "momentum":
        out_specs.append(pl.BlockSpec((tile_i,),
                                      lambda i, s: (s * n_iblocks + i,)))
        out_shape.append(jax.ShapeDtypeStruct((n_spans * ni_pad,),
                                              jnp.int32))
    out = pl.pallas_call(
        kernel,
        grid=(n_iblocks, n_spans),
        in_specs=[
            pl.BlockSpec((2,), lambda i, s: (0,)),
            pl.BlockSpec((NUM_FEATS, tile_i), lambda i, s: (0, i)),
            pl.BlockSpec((NUM_FEATS, nj_pad), lambda i, s: (0, 0)),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps(tile_i, tile_j), num_stages=NUM_STAGES),
        interpret=interpret,
        name="pair_accumulators_kernel",
    )(offsets, feats_i_t, feats_j_t)
    spans = out[0].reshape(n_spans, NUM_CH, ni_pad)[:, :, :ni]
    par = out[1].reshape(n_spans, ni_pad)[:, :ni] if mode == "momentum" \
        else None
    if n_spans == 1:
        return spans[0].T, (par[0] if par is not None else None)
    # additive channels sum over spans; the momentum candidate is the
    # heaviest over spans, and among equal masses the lowest id
    raw = jnp.sum(spans, axis=0)
    if par is not None:
        best = jnp.max(spans[:, 6], axis=0)
        raw = raw.at[6].set(best)
        par = jnp.min(jnp.where(spans[:, 6] == best, par, _I32_MAX), axis=0)
    return raw.T, par


def _pack_raw(acc: PairAccumulators, mode: str, dim: int) -> jax.Array:
    """PairAccumulators -> the kernel's raw channel block (module docstring
    layout); the inverse of decode_raw on every differentiable channel."""
    c = acc.force.shape[0]
    chans = [acc.force[:, d] for d in range(dim)]
    if mode == "reference":
        chans += [acc.gained_mass, acc.gained_radius,
                  acc.died.astype(jnp.float32)]
    elif mode == "elastic":
        chans += [0.5 * acc.dv[:, d] for d in range(dim)]
    z = jnp.zeros((c,), jnp.float32)
    chans += [z] * (6 - len(chans))
    chans += [acc.best_mass if mode == "momentum" else z, z]
    return jnp.stack(chans, axis=1)


def raw_reference(feats_i, feats_j_t, i_offset, j_offset, *, mode: str,
                  eps: float, growth_rate: float, dim: int = 2) -> jax.Array:
    """The kernel's f32[Ni, NUM_CH] raw channels in plain jnp: the oracle's
    pair math (pairwise.pair_accumulators_chunk) chunked over i so each
    [chunk, Nj] temporary stays near 2^22 elements. Forward values agree
    with the kernel on every channel decode_raw reads, and its VJP is the
    kernel's backward."""
    unpack = lambda f: (f[:, :dim], f[:, dim:2 * dim], f[:, 2 * dim],
                        f[:, 2 * dim + 1])
    ni, nj = feats_i.shape[0], feats_j_t.shape[1]
    pos_j, vel_j, mass_j, rad_j = unpack(feats_j_t.T)
    jj = j_offset + jnp.arange(nj, dtype=jnp.int32)
    chunk = max(8, min(ni, (1 << 22) // max(nj, 1)))
    nchunks = -(-ni // chunk)
    fi = _pad_to(feats_i, nchunks * chunk, 0)
    ii = i_offset + jnp.arange(nchunks * chunk, dtype=jnp.int32)

    def one_chunk(c):
        s = c * chunk
        acc = pair_accumulators_chunk(
            *unpack(lax.dynamic_slice_in_dim(fi, s, chunk)),
            lax.dynamic_slice_in_dim(ii, s, chunk),
            pos_j, vel_j, mass_j, rad_j, jj,
            eps2=jnp.float32(eps) * jnp.float32(eps),
            growth_rate=jnp.float32(growth_rate), mode=mode)
        return _pack_raw(acc, mode, dim)

    out = lax.map(one_chunk, jnp.arange(nchunks))
    return out.reshape(nchunks * chunk, NUM_CH)[:ni]


def decode_raw(raw, parent_raw, i_offset, mass_i, mode: str,
               dim: int = 2) -> PairAccumulators:
    """Unpack the channel block into PairAccumulators (see module docstring
    for the dim-dependent channel positions). ``parent_raw`` is the
    momentum-mode i32[N] parent ids (None for other modes).

    The hot loop carries no alive-i masks (dead-i rows compute junk); they are
    zeroed here, once per i body, to match the oracle exactly.
    """
    n = raw.shape[0]
    alive = mass_i > 0
    ids = jnp.asarray(i_offset, jnp.int32) + jnp.arange(n, dtype=jnp.int32)
    force = jnp.where(alive[:, None], raw[:, 0:dim], 0.0)
    z = jnp.zeros((n,), jnp.float32)
    gm = gr = z
    died = jnp.zeros((n,), bool)
    best_mass = jnp.full((n,), -jnp.inf, jnp.float32)
    parent = ids
    dv = jnp.zeros((n, dim), jnp.float32)
    if mode == "reference":
        gm = jnp.where(alive, raw[:, dim], 0.0)
        gr = jnp.where(alive, raw[:, dim + 1], 0.0)
        died = (raw[:, dim + 2] > 0) & alive
    elif mode == "momentum":
        any_cand = (raw[:, 6] > _NEG_INF) & alive
        best_mass = jnp.where(any_cand, raw[:, 6], -jnp.inf)
        parent = jnp.where(any_cand, parent_raw, ids)
    elif mode == "elastic":
        # the kernel accumulates m_j/(m_i+m_j) * vdotp/d2 * dp; the impulse
        # formula's factor 2 is applied here, once per i body
        dv = jnp.where(alive[:, None], 2.0 * raw[:, dim:2 * dim], 0.0)
    return PairAccumulators(force=force, gained_mass=gm, gained_radius=gr,
                            died=died, best_mass=best_mass, parent=parent,
                            dv=dv)


def pallas_pair_accumulators(pos, vel, mass, radius, *, eps: float = 0.0,
                             growth_rate: float = 0.1,
                             mode: str = "reference",
                             tile_i: int = DEFAULT_TILE_I,
                             tile_j: int = DEFAULT_TILE_J,
                             interpret: bool = False) -> PairAccumulators:
    """Drop-in kernel replacement for physics.pairwise.pair_accumulators."""
    dim = pos.shape[-1]
    feats = body_features(pos, vel, mass, radius)
    raw, par = tile_accumulators_raw(feats, feats.T, 0, 0, mode=mode, eps=eps,
                                     growth_rate=growth_rate, tile_i=tile_i,
                                     tile_j=tile_j, interpret=interpret,
                                     dim=dim)
    return decode_raw(raw, par, 0, mass, mode, dim=dim)
