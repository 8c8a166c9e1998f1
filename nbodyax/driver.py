"""Simulation driver: the analog of the reference's main() loop
(/root/reference/src/nbody.cu:373-551), rebuilt for device-resident state.

Reference loop per iteration: upload blob, ComputeForces, MoveBodies, download
blob, host-compact dead bodies, save last frame, launch next frame render
(two streams, frame one iteration behind). Here: state never leaves the
device; steps run in jit; frames render on-device every k-th iteration and are
written by a background thread; metrics and checkpoints at configurable
cadence. No per-step allocation churn (quirk Q9 eliminated).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import numpy as np

from nbodyax.backends import build_accum_fn, resolve_backend
from nbodyax.config import SimConfig
from nbodyax.io.checkpoint import load_checkpoint, save_checkpoint
from nbodyax.metrics import JsonlLogger, StepMeter, scalars_from_vec
from nbodyax.physics.step import PhysicsParams, make_step
from nbodyax.render import FrameWriter, render_state
from nbodyax.scenes import init_scene
from nbodyax.state import SimState

__all__ = ["run_simulation", "RunResult", "build_step", "resolve_bh_config"]


@dataclass
class RunResult:
    state: SimState
    steps_per_sec: float
    pairs_per_sec: float
    wall_seconds: float
    frames_written: int
    windows: int = 0  # device dispatch windows (scheduler diagnostics)


def _run_k(step, state, k):
    for _ in range(k):
        state = step(state)
    return state


# one device dispatch is capped near this many pairs; beyond it the pair pass
# splits into multiple dispatches, so no single device execution runs for
# minutes (see make_split_step)
MAX_PAIRS_PER_DISPATCH = 4.5e12

# fused multi-step windows are ALSO wall-bounded: the pair budget above
# guards one step's dispatch, but a cadence-sized window (lax.fori_loop over
# k steps) multiplies it. Windows are clipped to the wall predicted from the
# LAST window's metered per-step time; right after any step (re)build —
# fresh process, bhAdapt retune — no estimate exists and heavy runs take one
# small bootstrap window to measure first.
MAX_WINDOW_SECONDS = 75.0
BOOTSTRAP_WINDOW_STEPS = 8

# merger-phase ("drift") hardening for bh+bhAdapt runs: while the live count
# is falling fast or the last health probe saw overflow, the probe runs at
# every WINDOW boundary (one cheap dispatch) instead of every log point, K
# widens with headroom past the measured need, and windows clip short — so
# adaptation outpaces the density drift. Probing only at log cadence let a
# 4M-galaxy merger accumulate 424k bodies (23% of alive) over the partner
# cap inside one 50-step probe gap, i.e. that many bodies silently skipped
# collision physics; the reference evaluates every pair
# unconditionally (/root/reference/src/nbody.cu:196-226).
DRIFT_WINDOW_STEPS = 16
DRIFT_ALIVE_FRAC = 0.005   # probe when alive dropped >0.5% since last probe
DRIFT_K_HEADROOM = 1.5     # widen K past the measured need while drifting


def resolve_bh_config(cfg: SimConfig, capacity: int = 0,
                      state: Optional[SimState] = None,
                      quiet: bool = True) -> SimConfig:
    """Resolve ``forceModel=bh`` auto knobs (bhLevels, bhNear, bhNeighborK)
    to concrete values. With a starting ``state``, levels and engine are
    probed density-aware (barneshut.pick_levels: coarse where the scene
    allows, finer where clustering would overflow the near-field cap);
    without one, the uniform-density heuristics apply and the engine is
    picked by the measured size crossover (rows below ~1.5M bodies, slots
    above — barneshut._SLOTS_PREFERRED_N). Idempotent on resolved configs;
    non-bh configs pass through unchanged."""
    if cfg.force_model != "bh":
        return cfg
    import dataclasses
    capacity = capacity or (state.capacity if state is not None
                            else cfg.particle_count)
    if cfg.bh_levels == 0 or cfg.bh_near == "auto":
        from nbodyax.physics.barneshut import _SLOTS_PREFERRED_N
        if state is not None:
            from nbodyax.physics.barneshut import pick_levels
            lv, near, kk, comp = pick_levels(
                state.pos, state.mass, neighbor_k=cfg.bh_neighbor_k,
                ring=cfg.bh_ring, near=cfg.bh_near, levels=cfg.bh_levels)
            # kk/comp are count-aware EXACT for this state (zero partner-cap
            # overflow, zero completion-budget drop — collisions are never
            # silently truncated); pinned K/compCap pass through untouched
            cfg = dataclasses.replace(
                cfg, bh_near=near, bh_levels=cfg.bh_levels or lv,
                bh_neighbor_k=kk,
                bh_comp_cap=cfg.bh_comp_cap or comp)
            if not quiet:
                print(f"bh auto-selected: bhLevels={cfg.bh_levels} "
                      f"bhNear={cfg.bh_near} bhNeighborK={kk}"
                      + (f" bhCompCap={cfg.bh_comp_cap}"
                         if cfg.bh_comp_cap else ""))
        elif cfg.bh_near == "auto":
            near = "slots" if capacity >= _SLOTS_PREFERRED_N else "rows"
            cfg = dataclasses.replace(cfg, bh_near=near)
    if cfg.bh_neighbor_k == 0 and cfg.bh_levels > 0:
        # concrete K in cfg so bhAdapt's widening and the health probe see
        # the resolved value (0 = auto stays only when levels are auto too,
        # in which case the accumulators resolve both internally)
        from nbodyax.physics.barneshut import auto_neighbor_k
        cfg = dataclasses.replace(cfg, bh_neighbor_k=auto_neighbor_k(
            capacity, cfg.bh_levels, cfg.bh_ring, cfg.dimensions,
            cfg.bh_near))
        if not quiet:
            print(f"bhNeighborK auto-selected: {cfg.bh_neighbor_k}")
    return cfg


def build_step(cfg: SimConfig, capacity: int = 0,
               state: Optional[SimState] = None,
               quiet: bool = True) -> Callable[[SimState], SimState]:
    """Step function per config: physics params + backend (+ ring when
    shards > 1, + split dispatches when capacity^2 exceeds the per-dispatch
    pair budget). bh auto knobs resolve via ``resolve_bh_config`` (pass
    ``state`` for the density-aware choice)."""
    cfg = resolve_bh_config(cfg, capacity=capacity, state=state, quiet=quiet)
    p = PhysicsParams.from_config(cfg)
    capacity = capacity or cfg.particle_count
    if cfg.shards > 1:
        # leapfrog's KDK runs two full ring passes inside the one dispatch;
        # yoshida4's composition runs four
        passes = {"euler": 1, "leapfrog": 2, "yoshida4": 4}[cfg.integrator]
        if (cfg.force_model != "bh"
                and passes * float(capacity) ** 2 / cfg.shards
                > MAX_PAIRS_PER_DISPATCH):
            # the ring step runs each shard's full pass as ONE device
            # dispatch of ~capacity^2/shards pairs; past the per-dispatch
            # budget that execution can outlive device watchdogs (the limit
            # the split-dispatch path exists to respect)
            import warnings
            warnings.warn(
                "sharded exact step: "
                f"~{passes * float(capacity) ** 2 / cfg.shards:.2e}"
                f" pairs per device dispatch exceeds the "
                f"{MAX_PAIRS_PER_DISPATCH:.1e} per-dispatch budget; very long"
                " uninterruptible device executions may hit runtime "
                "watchdogs (use forceModel=bh or more shards at this N)")
        if cfg.force_model == "bh":
            from nbodyax.sharding.bh import make_sharded_bh_step
            return make_sharded_bh_step(cfg, p)
        from nbodyax.sharding.ring import make_sharded_step
        return make_sharded_step(cfg, p)
    if cfg.force_model == "bh":
        return make_step(p, accum_fn=build_accum_fn(cfg.backend, p, cfg))
    n_splits = int(np.ceil(float(capacity) ** 2 / MAX_PAIRS_PER_DISPATCH))
    if n_splits > 1 and resolve_backend(cfg.backend) == "pallas":
        from nbodyax.physics.step import make_split_step
        step = make_split_step(p, n_splits, dim=cfg.dimensions)
        step._host_loop = True  # driver: don't wrap in lax.fori_loop
        return step
    if n_splits > 1:
        # the split path rides the Pallas tile kernel; the jnp backend has
        # no split equivalent, so past the budget it issues one unbounded
        # device execution — surface it instead of silently risking the
        # ~2-min execution watchdog (see MAX_PAIRS_PER_DISPATCH)
        import warnings
        warnings.warn(
            f"jnp backend: ~{float(capacity) ** 2:.2e} pairs run as one "
            f"device dispatch (no split path off-Pallas), past the "
            f"{MAX_PAIRS_PER_DISPATCH:.1e} per-dispatch budget — very long "
            "uninterruptible executions may hit runtime watchdogs")
    accum_fn = build_accum_fn(cfg.backend, p)
    return make_step(p, accum_fn=accum_fn)


def _bh_ck_extra(cfg: SimConfig):
    """Checkpoint metadata: the CURRENT (resolved/adapted) bh knobs, so a
    resume jumps straight to the working knob set (see save_checkpoint)."""
    if cfg.force_model != "bh":
        return None
    return {"bh_levels": cfg.bh_levels,
            "bh_neighbor_k": cfg.bh_neighbor_k,
            "bh_comp_cap": cfg.bh_comp_cap,
            "bh_near_slots": 1 if cfg.bh_near == "slots" else 0}


def _adopt_ck_knobs(cfg: SimConfig, path: str, quiet: bool = True):
    """Adopt a checkpoint's saved bh knobs into the USER-AUTO fields of
    ``cfg``. Mid-merger, the adapted knobs are the product of several
    multi-minute recompiles; re-walking that ladder on every resume wastes
    the wall. Pinned user knobs are never overridden."""
    if cfg.force_model != "bh":
        return cfg
    from nbodyax.io.checkpoint import load_checkpoint_extra
    meta = load_checkpoint_extra(path)
    if "bh_levels" not in meta:
        return cfg
    new = {}
    if cfg.bh_levels == 0 and meta["bh_levels"]:
        new["bh_levels"] = int(meta["bh_levels"])
    if cfg.bh_neighbor_k == 0 and meta.get("bh_neighbor_k"):
        new["bh_neighbor_k"] = int(meta["bh_neighbor_k"])
    if cfg.bh_comp_cap == 0 and meta.get("bh_comp_cap"):
        new["bh_comp_cap"] = int(meta["bh_comp_cap"])
    if cfg.bh_near == "auto" and "bh_near_slots" in meta:
        new["bh_near"] = "slots" if meta["bh_near_slots"] else "rows"
    if new:
        import dataclasses
        cfg = dataclasses.replace(cfg, **new)
        if not quiet:
            print(f"resumed bh knobs from checkpoint: {new}")
    return cfg


def run_simulation(cfg: SimConfig, *, quiet: bool = False,
                   state: Optional[SimState] = None,
                   profile_dir: Optional[str] = None) -> RunResult:
    """Run to completion. With ``autoResume`` (and checkpointing) enabled,
    runtime failures — device resets, preemptions — reload the latest
    checkpoint and continue, up to ``maxRetries`` attempts. This is the
    framework's recovery story (SURVEY.md section 5: fail-fast + checkpoint
    restart; the reference can only crash, nbody.cu:20-33)."""
    attempts = 1 + (cfg.max_retries if cfg.auto_resume and
                    cfg.checkpoint_every else 0)
    last_err: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return _run_simulation_once(cfg, quiet=quiet, state=state,
                                        profile_dir=profile_dir)
        except (RuntimeError, jax.errors.JaxRuntimeError) as e:
            from nbodyax.render import FrameWriteError
            if isinstance(e, FrameWriteError):
                # host IO failure (e.g. full disk): reloading a checkpoint
                # cannot fix it — retrying would just burn maxRetries
                raise
            last_err = e
            if attempt + 1 >= attempts:
                raise
            from nbodyax.io.checkpoint import latest_checkpoint
            ck = latest_checkpoint(cfg.checkpoint_path)
            if ck is None:
                raise
            if not quiet:
                print(f"Run failed ({type(e).__name__}); resuming from {ck} "
                      f"(attempt {attempt + 2}/{attempts})")
            # hand the checkpoint PATH to the next attempt (not a loaded
            # state): _run_simulation_once then adopts the snapshot's
            # saved bh knobs uniformly with a cold process-level resume
            import dataclasses
            cfg = dataclasses.replace(cfg, resume_from=ck)
            state = None
    raise last_err  # unreachable


def _run_simulation_once(cfg: SimConfig, *, quiet: bool = False,
                         state: Optional[SimState] = None,
                         profile_dir: Optional[str] = None) -> RunResult:
    t_start = time.perf_counter()  # analog of jbutil::gettime (nbody.cu:374)
    logger = JsonlLogger(cfg.log_path, echo=not quiet)

    # which bh knobs the USER left auto — captured before any checkpoint
    # adoption or resolution so compaction's re-resolve (below) knows what
    # it may re-pick
    auto_knobs = {"bh_levels": cfg.bh_levels == 0,
                  "bh_near": cfg.bh_near == "auto",
                  "bh_neighbor_k": cfg.bh_neighbor_k == 0,
                  "bh_comp_cap": cfg.bh_comp_cap == 0}
    if state is None:
        if cfg.resume_from:
            state = load_checkpoint(cfg.resume_from)
            cfg = _adopt_ck_knobs(cfg, cfg.resume_from, quiet=quiet)
            if not quiet:
                print(f"Resumed from {cfg.resume_from} at step "
                      f"{int(np.asarray(state.step))}")
        else:
            state = init_scene(cfg)
    start_step = int(np.asarray(state.step))

    if cfg.shards > 1:
        from nbodyax.sharding.mesh import (make_mesh, maybe_init_distributed,
                                           pad_to_shards, shard_state)
        maybe_init_distributed()
        mesh = make_mesh(cfg.shards)
        state = shard_state(pad_to_shards(state, cfg.shards), mesh)

    # density-aware bh knob resolution against the actual starting state;
    # the driver needs the resolved cfg itself (bh_health / bhAdapt below).
    # ``auto_knobs`` (captured above, pre-adoption) lets compaction
    # re-resolve the user-auto knobs against the shrunken population.
    cfg = resolve_bh_config(cfg, capacity=state.capacity, state=state,
                            quiet=quiet)

    step = build_step(cfg, capacity=state.capacity)
    meter = StepMeter(capacity=state.capacity)
    writer = (FrameWriter(cfg.image_path)
              if cfg.save_images and cfg.save_image_every > 0 else None)
    frames = 0

    # host touch-points (log / checkpoint / compact) have a fixed cadence;
    # any stretch between them runs as ONE device dispatch (lax.fori_loop
    # over the jitted step) so host/dispatch latency never gates small-N
    # throughput. Windows run to the NEXT DUE EVENT (the nearest upcoming
    # multiple of any cadence), clipped so no window straddles a frame
    # boundary from a misaligned start — coprime cadences (logEvery=10,
    # checkpointEvery=7) therefore cost O(events) dispatches, not the
    # per-step cliff a gcd stride would degenerate to (gcd=1). Frames do
    # NOT bound aligned windows: all of a window's frames render in-jit
    # into one stacked buffer (fpw frames/dispatch) — on high-latency
    # transports one dispatch per frame costs far more than the fused
    # rasterizes.
    import math
    k_img = (cfg.save_image_every
             if cfg.save_images and cfg.save_image_every > 0 else 0)
    cadences = [c for c in (cfg.log_every, cfg.checkpoint_every,
                            cfg.compact_every, cfg.energy_every) if c]
    base = math.gcd(*cadences) if cadences else (16 * k_img if k_img else 64)
    if k_img and base % k_img:
        base = math.gcd(base, k_img)
    # the RECURRING window size: when cadences share their gcd as an actual
    # gap (the aligned common case) every window is `stride` long and rides
    # the statically-compiled runner; other gaps use the dynamic runner
    stride = base

    def next_window(i):
        """Steps from i to the nearest due event (cadence multiple, end of
        run, or — from a frame-misaligned start — the next frame boundary,
        so every frame window starts at a multiple of the frame cadence)."""
        k = cfg.total_iterations - i
        for c in cadences:
            k = min(k, c - i % c)
        if not cadences:
            k = min(k, stride - i % stride)
        if k_img:
            r = i % k_img
            if r:
                k = min(k, k_img - r)
        return k

    host_loop = getattr(step, "_host_loop", False)
    runners = {}
    snap_runners = {}
    dyn_runner = []
    # only the RECURRING window size (the stride) gets its own static
    # compile; every other size (coprime-cadence gaps, one-off tails,
    # misaligned-resume re-alignment) shares ONE dynamic-trip-count runner
    # — a single extra compile instead of per-step dispatches or a compile
    # per distinct gap.
    compiled_ks = {stride}

    from nbodyax.metrics import _conservation_vec

    def advance_k(s, k):
        """k steps as one device dispatch (jitted fori_loop: static trip
        count for the recurring stride, traced trip count for every other
        size); the split-dispatch step stays host-orchestrated. Returns
        (state, conservation vec): the vec rides the window dispatch (its
        device cost is noise) and its host fetch doubles as the window's
        completion fence AND the log payload — one round-trip per window
        instead of three."""
        if host_loop:
            s = _run_k(step, s, k)
            return s, _conservation_vec(s)
        if k in compiled_ks:
            run = runners.get(k)
            if run is None:
                @jax.jit
                def run(s, _k=k):
                    out = jax.lax.fori_loop(0, _k, lambda i, st: step(st), s)
                    return out, _conservation_vec(out)
                runners[k] = run
            return run(s)
        if not dyn_runner:
            @jax.jit
            def dyn(s, kk):
                out = jax.lax.fori_loop(0, kk, lambda i, st: step(st), s)
                return out, _conservation_vec(out)
            dyn_runner.append(dyn)
        return dyn_runner[0](s, np.int32(k))

    def advance_frame_window(s, k):
        """k steps + every due frame as ONE fused device dispatch. Frame
        ``iteration + m*k_img`` holds post-step state under that index
        (reference content, nbody.cu:529-538): in-window step i satisfies
        i % k_img == 0 exactly when the just-completed global step carries a
        frame label, and the rasterize rides the metered window — on
        high-latency transports an extra dispatch per frame costs far more
        than the in-jit rasterize (~N*patch^2 elementwise ops). Returns
        (state, frames) with frames stacked [ceil(k/k_img), H, W]."""
        nf = -(-k // k_img)
        if host_loop or k not in compiled_ks:
            imgs = []
            done = 0
            while done < k:
                s, _ = advance_k(s, 1)
                imgs.append(render_state(s, cfg))
                kk = min(k_img - 1, k - done - 1)
                if kk:
                    s, _ = advance_k(s, kk)
                done += 1 + kk
            return s, imgs, _conservation_vec(s)
        run = snap_runners.get(k)
        if run is None:
            import jax.numpy as jnp
            from jax import lax

            @jax.jit
            def run(s, _k=k, _nf=nf):
                probe = render_state(s, cfg)      # shape/dtype only
                buf = jnp.zeros((_nf,) + probe.shape, probe.dtype)

                def body(i, carry):
                    st, b = carry
                    st = step(st)

                    def snap(b):
                        img = render_state(st, cfg)
                        return lax.dynamic_update_slice(
                            b, img[None], (i // k_img,)
                            + (0,) * probe.ndim)

                    b = lax.cond(i % k_img == 0, snap, lambda b: b, b)
                    return st, b

                out, b = lax.fori_loop(0, _k, body, (s, buf))
                return out, b, _conservation_vec(out)
            snap_runners[k] = run
        s, buf, vec = run(s)
        # ONE host fetch for the whole window's frames: per-frame device
        # slices would each cost a dispatch + fetch round-trip
        imgs = np.asarray(buf)
        return s, [imgs[m] for m in range(nf)], vec

    if cfg.checkpoint_every and cfg.auto_resume and not cfg.resume_from:
        # a crash BEFORE the first cadence checkpoint must still be
        # resumable: autoResume reloads the latest snapshot, and with none
        # on disk the whole run dies. Persist the starting state up front;
        # retention treats it like any other.
        save_checkpoint(cfg.checkpoint_path, state,
                        keep_last=cfg.checkpoint_keep,
                        milestone_every=cfg.checkpoint_milestone_every,
                        extra=_bh_ck_extra(cfg))

    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    windows = 0
    # last window's metered per-step wall; None right after any step
    # (re)build = "unmeasured regime" (see MAX_WINDOW_SECONDS)
    est_step_wall = None
    # bhAdapt persistence trackers: overflow below the noise floor adapts
    # on the SECOND consecutive nonzero health check (see bh_probe_adapt)
    prev_overflow = prev_dropped = 0.0
    # drift detector state (see DRIFT_WINDOW_STEPS): alive count at the
    # last health probe, and whether the run is in the merger-phase regime
    last_probe_alive = None
    drift_mode = False
    if cfg.force_model == "bh" and cfg.bh_adapt:
        # seed the detector so the FIRST windows of a merging run already
        # trigger per-window probes (one scalar fetch at startup)
        import jax.numpy as jnp
        last_probe_alive = float(jnp.sum(state.mass > 0))
    prev_sim_time = float(np.asarray(state.sim_time))
    prev_log_iter = start_step
    last_ck_step = start_step

    def bh_probe_adapt(s, alive_now, at_step):
        """One ``bh_health`` dispatch+fetch plus the bhAdapt response
        ladder. Runs at every log point, and — while ``drift_mode`` is on
        or the live count just dropped fast — at every window boundary, so
        adaptation outpaces merger-phase density drift instead of sampling
        it at log cadence (a 50-step probe gap accumulated 424k bodies
        over the partner cap in the 4M galaxy merger). Returns
        the fetched health vector for the log line."""
        nonlocal cfg, step, host_loop, est_step_wall
        nonlocal prev_overflow, prev_dropped, drift_mode, last_probe_alive
        from nbodyax.physics.barneshut import bh_health
        # [partner-cap overflow, completion-budget overflow, max radius,
        # min span, count-aware minimal partner cap, completion-pass
        # population] in one dispatch+fetch: h[0]+h[1] bodies are invisible
        # to the near field this step
        h = np.asarray(bh_health(
            s.pos, s.mass, s.radius,
            levels=cfg.bh_levels, neighbor_k=cfg.bh_neighbor_k,
            ring=cfg.bh_ring, near=cfg.bh_near, comp_cap=cfg.bh_comp_cap,
            n_giants=getattr(cfg, "bh_giants", 0)))
        dropping = (last_probe_alive is not None
                    and alive_now < last_probe_alive
                    * (1.0 - DRIFT_ALIVE_FRAC))
        last_probe_alive = alive_now
        if not cfg.bh_adapt:
            return h
        # self-tuning between windows (bounded recompiles):
        # collapsing/merging runs drift out of any fixed (levels, K)
        # envelope — widen K to the probe's count-aware minimal cap on
        # partner-cap overflow (one recompile makes the near field exact
        # again; overflow is a binary collision-physics error, so ANY
        # persistent overflow adapts, with a one-check delay below the
        # 64-body noise floor so a single transient body crossing a cell
        # boundary doesn't buy a multi-minute recompile), refine levels on
        # completion-budget overflow, coarsen levels when grown radii
        # outrun the ring's collision coverage (approximation 1/2 in
        # barneshut's docstring)
        new = {}
        noise = max(64.0, 1e-3 * alive_now)
        persistent = h[0] > noise or (h[0] > 0 and prev_overflow > 0)
        prev_overflow = h[0]
        if persistent:
            if cfg.bh_near == "slots":
                # the slots cap is max(K, slot_cap): raising K below that
                # floor is a no-op
                from nbodyax.physics.barneshut import slot_cap
                eff = max(cfg.bh_neighbor_k, slot_cap(
                    s.capacity, (1 << cfg.bh_levels) ** cfg.dimensions))
            else:
                eff = cfg.bh_neighbor_k
            want = int(h[4])
            if dropping or h[0] > noise:
                # drift headroom: an exact-at-probe-time cap is outgrown
                # within the next window while cells are still collapsing
                # — widen PAST the measured minimum so one recompile holds
                # through continued drift (equality-sized caps
                # re-overflowed at every probe of the merger)
                want = int(want * DRIFT_K_HEADROOM)
            # the slot grid allocates cells * max(K, slot_cap) rows — K
            # is memory-bounded per grid (64M rows ~ 2 GB of 8-channel f32;
            # an unbounded widening at a fine grid is a guaranteed OOM)
            k_budget = max(40, 8 * ((64 * (1 << 20)
                           >> (cfg.dimensions * cfg.bh_levels)) // 8))
            need = min(1024, k_budget, 8 * -(-want // 8))
            if eff < need:
                # widen straight to the (headroom-padded) measured need; a
                # guard on the EFFECTIVE cap: when slot_cap already covers
                # it, raising the config K changes nothing and would cost
                # a futile multi-minute recompile
                new["bh_neighbor_k"] = need
        cell = h[3] / (1 << cfg.bh_levels)
        # refinement respects the dimension-aware grid cap (3-D octrees
        # cap at 7 levels: 2^(3*8) cells would blow the documented
        # device-memory budget — same bound config.validate() enforces)
        max_adapt_lv = 7 if cfg.dimensions == 3 else 10
        # radius-outgrows-window coarsening ONLY without the giant pass
        # (bhGiants=0): with it, oversized bodies collide exactly at any
        # distance, while coarsening to chase the single largest radius
        # multiplied near-field cost without bound (levels 9->8->7 with
        # K 48->688 inside 16 merger steps).
        # It is also occupancy-bounded: coarsening past the K=1024 slot
        # ceiling would overflow every cell — strictly worse than the
        # distant-overlap misses it repairs.
        occ_next = alive_now / (1 << (cfg.dimensions * (cfg.bh_levels - 1)))
        if (not getattr(cfg, "bh_giants", 0)
                and 2.0 * h[2] > cfg.bh_ring * cell and cfg.bh_levels > 2
                and occ_next * 2.5 <= 1024):
            new["bh_levels"] = cfg.bh_levels - 1
        elif ((h[1] > noise or (h[1] > 0 and prev_dropped > 0))
                and "bh_neighbor_k" not in new):
            # crowded cells past slot_cap AND the per-body completion
            # budget: any persistent drop adapts (those bodies get NO
            # physics at all), same policy as widening. Response ladder:
            # when the budget was RIGHT-SIZED by pick_levels (small
            # static list for a small population) and drift merely
            # outgrew it, re-widen it toward the default ~n/16 first
            # (cheap recompile); reach for a finer grid only when the
            # population itself is default-budget-scale, and at the
            # level cap widen past the default instead (+12.5% slack,
            # 1024-tiered — mirrors pick_levels' startup choice)
            pop = int(h[5])
            need_comp = min(s.capacity, 1024 * -(-(pop + pop // 8) // 1024))
            default_comp = min(s.capacity, max(1024, s.capacity // 16))
            # would refining actually fit? the finer slot grid's rows are
            # cells * S; refining while keeping an adapt-widened K
            # multiplied into device-memory exhaustion (levels 9->10 with
            # the K=288 it had just widened = a ~7 GB slot table) — so a
            # refine RESETS K to the finer grid's
            # heuristic and is skipped when even that grid would blow
            # the ~2 GB slot-table budget
            from nbodyax.physics.barneshut import auto_neighbor_k, slot_cap
            cells_f = 1 << (cfg.dimensions * (cfg.bh_levels + 1))
            k_f = auto_neighbor_k(s.capacity, cfg.bh_levels + 1,
                                  cfg.bh_ring, cfg.dimensions, cfg.bh_near)
            refine_fits = (cells_f * max(k_f, slot_cap(s.capacity, cells_f))
                           <= 64 * (1 << 20))
            # drift headroom x2: each +12.5% widening was outgrown by the
            # NEXT probe during the core collapse — five recompiles in
            # five steps (comp 248k -> 683k) where one doubled
            # budget would have held
            need_drift = min(s.capacity, 1024 * -(-(2 * pop) // 1024))
            if cfg.bh_comp_cap and need_comp <= default_comp:
                new["bh_comp_cap"] = need_comp
            elif (refine_fits and cfg.bh_levels < max_adapt_lv
                  and pop > s.capacity // 8):
                # the population fundamentally out-crowds this grid: a
                # finer grid shrinks S and with it the PER-BODY completion
                # row cost ((2*ring+1)*S) — widening the budget at the
                # coarse grid pays ~6x more per completion body
                new["bh_levels"] = cfg.bh_levels + 1
                new["bh_neighbor_k"] = k_f
            elif ((dropping or drift_mode)
                  and need_drift <= s.capacity // 4):
                # transient merger crowding: widen the budget in place
                # (one cheap recompile); refining mid-collapse churns
                # grids the post-compaction re-resolve discards anyway
                new["bh_comp_cap"] = need_drift
            elif cfg.bh_levels < max_adapt_lv and refine_fits:
                new["bh_levels"] = cfg.bh_levels + 1
                new["bh_neighbor_k"] = k_f
            elif need_comp > (cfg.bh_comp_cap or default_comp):
                new["bh_comp_cap"] = need_comp
        prev_dropped = h[1]
        if new:
            from dataclasses import replace as _dc
            # pessimistic scaled PRIOR for the next window's wall clip
            # instead of a blind 8-step bootstrap: an adapt can multiply
            # per-step cost (K 144->688 on a coarsened grid). Near-field
            # cost is ~linear in K; a coarsen without a K change raises
            # occupancy instead, so scale by 2 there. The prior
            # self-corrects after one measured window and only ever SHRINKS
            # the next window.
            ratio = 1.0
            if "bh_neighbor_k" in new and cfg.bh_neighbor_k > 0:
                ratio = new["bh_neighbor_k"] / cfg.bh_neighbor_k
            elif new.get("bh_levels", cfg.bh_levels) < cfg.bh_levels:
                ratio = 2.0
            if "bh_comp_cap" in new:
                # a widened completion budget is a static per-body list
                # whose cost is ~linear in the budget. Use the RAW budget
                # ratio, deliberately pessimistic: an 8x cap under-predicted
                # a 4096 -> 710656 widening ~25x. Overshooting only shrinks
                # the next window to 1 step; the measurement then takes
                # over.
                ratio = max(ratio, new["bh_comp_cap"]
                            / max(cfg.bh_comp_cap or 1024, 1024))
            prior = (est_step_wall * max(1.0, ratio)
                     if est_step_wall else None)
            cfg = _dc(cfg, **new)
            step = build_step(cfg, capacity=s.capacity)
            host_loop = getattr(step, "_host_loop", False)
            runners.clear()
            snap_runners.clear()
            # the dynamic-trip-count runner also closed over the OLD step
            # at trace time; same shapes would never retrace it, silently
            # dropping the adapt
            dyn_runner.clear()
            # adapted knobs (wider K, finer grid) can be a multiple of the
            # old per-step cost: clip the next window by the scaled prior
            # (or re-measure via the bootstrap when no estimate exists)
            est_step_wall = prior
            if not quiet:
                print(f"bh adapt at step {at_step}: {new}")
        drift_mode = bool(dropping or (h[0] + h[1]) > 0)
        return h
    try:
        iteration = start_step
        while iteration < cfg.total_iterations:
            # window to the next due event: absolute cadence multiples are
            # always window boundaries (so the due-checks below fire), a
            # misaligned first window (resume from a checkpoint whose step
            # is off-cadence) re-aligns naturally, and coprime cadences
            # produce O(events) windows instead of gcd=1 per-step dispatch
            k = next_window(iteration)
            # wall-budget clip (MAX_WINDOW_SECONDS): a cadence-sized fused
            # window can outlive the device execution watchdog; predict
            # from the last window's metered per-step wall, and take one
            # small bootstrap window in unmeasured heavy regimes (a fresh
            # or re-built step whose first window includes its compile —
            # the inflated estimate then self-corrects in one window)
            if est_step_wall is None:
                if cfg.force_model == "bh" and state.capacity >= (1 << 20):
                    k = min(k, BOOTSTRAP_WINDOW_STEPS)
            elif est_step_wall > 0:
                k = min(k, max(1, int(MAX_WINDOW_SECONDS / est_step_wall)))
            if drift_mode:
                # merger phase: short windows so the per-window health
                # probe below samples the drift, not its aftermath
                k = min(k, DRIFT_WINDOW_STEPS)
            if (writer is not None and k_img and iteration % k_img == 0
                    and k >= k_img):
                # frame windows stay frame-aligned after the clips — but
                # only ever rounded DOWN: rounding up to k_img would (1)
                # run past total_iterations on short tails, (2) skip
                # finer-cadence log/checkpoint events, (3) defeat the
                # wall clip above. A clipped k < k_img stays as-is:
                # advance_frame_window renders the one due frame at the
                # window start and next_window re-aligns the successor.
                k -= k % k_img
            windows += 1
            log_due = cfg.log_every and (iteration + k) % cfg.log_every == 0
            if writer is not None and iteration % cfg.save_image_every == 0:
                # reference frame iteration_j holds *post-step-j* state: the
                # render launches after iteration j's kernels, under j's
                # index (nbody.cu:529-538) — fused into the window dispatch
                meter.start()
                state, imgs, vec = advance_frame_window(state, k)
                v = np.asarray(vec)     # fences the window (see advance_k)
                est_step_wall = meter.stop(None, steps=k) / k
                for m, img in enumerate(imgs):
                    writer.submit(iteration + m * k_img, img)  # async write
                frames += len(imgs)
            else:
                meter.start()
                state, vec = advance_k(state, k)
                v = np.asarray(vec)     # fences the window (see advance_k)
                est_step_wall = meter.stop(None, steps=k) / k
            iteration += k
            win_step_wall = est_step_wall  # this window's metered wall
            alive_now = float(v[0])
            if (cfg.force_model == "bh" and not log_due
                    and iteration < cfg.total_iterations
                    and cfg.bh_adapt
                    and (drift_mode or (last_probe_alive is not None
                         and alive_now < last_probe_alive
                         * (1.0 - DRIFT_ALIVE_FRAC)))):
                # off-cadence drift probe: the conservation vec already
                # rode this window's dispatch, so detecting the merger
                # phase costs nothing; the probe itself is one dispatch
                bh_probe_adapt(state, alive_now, iteration)
            if log_due:
                scal = scalars_from_vec(v, cfg.dimensions)
                if cfg.adaptive_dt:
                    # mean dt over the steps since the last log line —
                    # the per-step dts are internal to the fused dispatch;
                    # their telescoped sum (sim_time) is what's observable
                    scal["dt_mean"] = ((scal["sim_time"] - prev_sim_time)
                                       / max(iteration - prev_log_iter, 1))
                prev_sim_time = scal["sim_time"]
                prev_log_iter = iteration
                if cfg.force_model == "bh":
                    h = bh_probe_adapt(state, alive_now, iteration)
                    scal["bh_overflow"] = int(h[0] + h[1])
                    # coverage-exceeding bodies beyond the exact-collision
                    # giant list (approximation-1 residual, not silent)
                    scal["bh_giant_excess"] = int(h[6])
                if cfg.energy_every and iteration % cfg.energy_every == 0:
                    # O(N^2) pair potential: opt-in, at its own (coarser)
                    # cadence — as expensive as a force pass
                    from nbodyax.metrics import potential_energy
                    pe = float(potential_energy(state, eps=cfg.softening))
                    scal["potential_energy"] = pe
                    scal["total_energy"] = pe + float(scal["kinetic_energy"])
                # bh does O(N*levels) work, not capacity^2: label its pair
                # rate as *equivalent*-exact so the JSONL is self-describing
                pairs_key = ("equivalent_pairs_per_sec"
                             if cfg.force_model == "bh" else "pairs_per_sec")
                # wall_ms = THIS window's metered per-step wall (not the
                # cumulative running average, which smears the first
                # window's multi-minute remote compile into every row)
                logger.log(step=iteration,
                           wall_ms=(win_step_wall if win_step_wall
                                    else meter.elapsed / meter.steps) * 1e3,
                           steps_per_sec=meter.steps_per_sec,
                           force_model=cfg.force_model,
                           **{pairs_key: meter.pairs_per_sec},
                           **scal)
            ck_due = (cfg.checkpoint_every
                      and iteration % cfg.checkpoint_every == 0)
            if (cfg.checkpoint_every and not ck_due and drift_mode
                    and iteration - last_ck_step
                    >= max(8, cfg.checkpoint_every // 4)):
                # merger-phase steps cost ~a minute each at 4M; losing a
                # whole cadence interval to a worker crash re-pays tens
                # of minutes — checkpoint at a finer effective cadence
                # while drifting (knob metadata rides along, so the
                # resume also skips the adapt-ladder recompiles)
                ck_due = True
            if ck_due:
                save_checkpoint(
                    cfg.checkpoint_path, state,
                    keep_last=cfg.checkpoint_keep,
                    milestone_every=cfg.checkpoint_milestone_every,
                    extra=_bh_ck_extra(cfg))
                last_ck_step = iteration
            compact_due = (cfg.compact_every
                           and iteration % cfg.compact_every == 0)
            if cfg.compact_every and not compact_due:
                # merger-phase early trigger: compact as soon as the live
                # count guarantees at least a halving (compact_state's
                # bucket is the pow-2 above alive*1.25, so alive*2.5 <=
                # capacity implies a strictly smaller bucket) — waiting
                # for the cadence multiple made a 4M galaxy run pay full
                # 4.19M-capacity structure cost through the whole merger
                compact_due = (alive_now * 2.5 <= state.capacity
                               and state.capacity > 256)
            if compact_due and iteration < cfg.total_iterations:
                from nbodyax.state import compact_state
                # sharded states compact too: compact_state's np.asarray
                # gathers the shards to host; a smaller bucket is re-padded
                # to the shard count and re-placed on the mesh. The gather
                # is O(state) host traffic at a coarse cadence — amortized
                # noise next to the O(capacity^2/P) pair math it shrinks
                # (the reference compacts EVERY step, nbody.cu:488-510).
                new_state = compact_state(state)
                if new_state.capacity != state.capacity:
                    if not quiet:
                        print(f"Compacted {state.capacity} -> "
                              f"{new_state.capacity} slots "
                              f"(reference analog: nbody.cu:488-510)")
                    if cfg.force_model == "bh" and any(auto_knobs.values()):
                        # re-resolve the USER-auto bh knobs against the
                        # compacted population: levels/K/compCap sized for
                        # the dead capacity (or adapt-widened during the
                        # merger) would otherwise persist until the next
                        # overflow forces an adapt
                        import dataclasses as _dcs
                        reset = {kk: ("auto" if kk == "bh_near" else 0)
                                 for kk, on in auto_knobs.items() if on}
                        cfg = _dcs.replace(cfg, **reset)
                        cfg = resolve_bh_config(
                            cfg, capacity=new_state.capacity,
                            state=new_state, quiet=quiet)
                        prev_overflow = prev_dropped = 0.0
                    if cfg.shards > 1:
                        new_state = shard_state(
                            pad_to_shards(new_state, cfg.shards), mesh)
                    # capacity-derived choices (split n_splits, bh caps,
                    # dispatch budgets) bake at build time — rebuild on
                    # ANY capacity change, single-device included (a stale
                    # n_splits kept a 4M->400k compaction paying 4
                    # dispatches per step)
                    step = build_step(cfg, capacity=new_state.capacity)
                    host_loop = getattr(step, "_host_loop", False)
                    runners.clear()
                    snap_runners.clear()
                    dyn_runner.clear()
                    est_step_wall = None
                    last_probe_alive = alive_now
                    state = new_state
                    meter.capacity = state.capacity
    finally:
        if profile_dir:
            jax.profiler.stop_trace()
        if writer is not None:
            writer.close()
        logger.close()

    jax.block_until_ready(state)
    wall = time.perf_counter() - t_start
    if not quiet:
        print(f"Time taken: {wall:.4f}")  # same format as nbody.cu:548
    return RunResult(state=state, steps_per_sec=meter.steps_per_sec,
                     pairs_per_sec=meter.pairs_per_sec, wall_seconds=wall,
                     frames_written=frames, windows=windows)
