"""Smoke test of nbodyax on NVIDIA GPUs: the quickest proof it still runs.

``python chip_smoke.py`` needs one GPU and runs, in one process, phase by
phase, stopping at the first failure:

1. device: the default device is a GPU; prints its kind, the card's name
   and power limit (nvidia-smi) and the compile-cache directory;
2. the pair kernel (physics/kernels.py), compiled for the card, against the
   jnp oracle (physics/pairwise.py) under ``highest`` matmul precision: all
   four collision modes in 2-D at N=131,072, reference mode in 3-D at
   N=131,072 and in 2-D at N=1,048,576, and 8,192 rows against all
   N=4,194,304 bodies (as the split-dispatch step calls the kernel; the j
   array runs as several spans), each gate printed beside the measured
   error;
3. the external C++ oracle's N=1,024, 200-step trajectory
   (tests/golden/ref_n1k.npz) through ``backend=auto``;
4. the CLI on the reference's default scene (examples/reference_default.txt:
   N=16,384, 2,000 steps, 200 PGM frames) in a temporary directory;
5. engines off the main path: ``forceModel=bh`` at N=262,144 for 3 steps,
   momentum and elastic collisions for 10 exact steps at N=16,384, and one
   ``jax.grad`` of examples/shooting_gradient.py's loss at N=1,024 through
   ``backend=auto`` against ``backend=jnp``.

``python chip_smoke.py --four-cards`` needs four GPUs and runs only the
paths that exist across cards: the ppermute ring step (``shards=4``, exact,
reference mode, N=262,144) and the sharded bh step (``shards=4``,
N=1,048,576), each against the same step on one card.

The last line of standard output is one JSON object, ``{"ok": true,
"device": {"platform": ..., "kind": ..., "count": ...}}``, printed only when
every phase passed. Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nbodyax.backends import build_accum_fn, resolve_backend
from nbodyax.cache import enable_compile_cache
from nbodyax.config import SimConfig
from nbodyax.physics import kernels
from nbodyax.physics.kernels import pallas_pair_accumulators
from nbodyax.physics.pairwise import pair_accumulators
from nbodyax.physics.step import PhysicsParams, make_step
from nbodyax.scenes import init_scene

ROOT = os.path.dirname(os.path.abspath(__file__))
FIELD = 100_000.0       # the reference's default scene (fieldWidth)


class PhaseFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|: the error scaled by the channel's maximum."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def elementwise_rel_err(a, b) -> float:
    """max |a - b| / |b| (0/0 counts as 0): the rtol assert_allclose needs."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return float(np.max(np.where(d == 0, 0.0, d / np.maximum(np.abs(b),
                                                               1e-300))))


def gate(name: str, err: float, limit: float) -> None:
    print(f"    {name}: {err:.3e} (gate {limit:.0e})")
    check(err < limit if limit > 0 else err == 0, f"{name} {err} >= {limit}")


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device(count: int) -> jax.Device:
    devs = jax.devices()
    dev = devs[0]
    check(dev.platform == "gpu", f"default device is {dev.platform}")
    check(len(devs) >= count, f"need {count} GPUs, found {len(devs)}")
    print(f"  device_kind: {dev.device_kind}, count {len(devs)}")
    print(f"  card (name, power limit): {card_name_and_limit()}")
    print(f"  compile cache: {enable_compile_cache()}")
    print(f"  backend=auto resolves to: {resolve_backend('auto')}")
    return dev


def random_bodies(n: int, dim: int, seed: int):
    """The default scene's ranges, with velocities (so elastic impulses
    fire) and every 97th slot dead."""
    kp, kv, km, kr = jax.random.split(jax.random.PRNGKey(seed), 4)
    pos = jax.random.uniform(kp, (n, dim), jnp.float32, -FIELD, FIELD)
    vel = jax.random.uniform(kv, (n, dim), jnp.float32, -50.0, 50.0)
    mass = jax.random.uniform(km, (n,), jnp.float32, 1e4, 1e17)
    mass = jnp.where(jnp.arange(n) % 97 == 0, 0.0, mass)
    radius = jax.random.uniform(kr, (n,), jnp.float32, 50.0, 200.0)
    return pos, vel, mass, radius


def phase_kernel() -> None:
    cases = [(m, 2, 131_072) for m in
             ("reference", "momentum", "elastic", "none")]
    cases += [("reference", 3, 131_072), ("reference", 2, 1_048_576)]
    for mode, dim, n in cases:
        bodies = random_bodies(n, dim, seed=n + dim)
        kern = jax.jit(partial(pallas_pair_accumulators, eps=0.0,
                               growth_rate=0.1, mode=mode))
        oracle = jax.jit(partial(pair_accumulators, eps=0.0, growth_rate=0.1,
                                 mode=mode, chunk=max(8, (1 << 26) // n)))
        t0 = time.perf_counter()
        a = jax.block_until_ready(kern(*bodies))
        t_kern = time.perf_counter() - t0
        with jax.default_matmul_precision("highest"):
            b = jax.block_until_ready(oracle(*bodies))
        print(f"  {mode}, {dim}-D, N={n} (kernel compile+run "
              f"{t_kern:.1f} s):")
        gate_accumulators(a, b, mode)
    phase_kernel_spans()


def phase_kernel_spans(n: int = 4_194_304, rows: int = 8192) -> None:
    """The first ``rows`` bodies against all ``n``, the call the
    split-dispatch step makes per i-range. Past MAX_LANE_TERMS tiles the
    kernel cuts the j array into spans; the oracle is raw_reference (the
    same raw channels from pairwise's pair math), chunked over the rows."""
    pos, vel, mass, radius = random_bodies(n, 2, seed=n + 2)
    feats = kernels.body_features(pos, vel, mass, radius)
    kw = dict(mode="reference", eps=0.0, growth_rate=0.1, dim=2)
    t0 = time.perf_counter()
    raw, _ = jax.block_until_ready(jax.jit(partial(
        kernels.tile_accumulators_raw, **kw))(feats[:rows], feats.T, 0, 0))
    t_kern = time.perf_counter() - t0
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(partial(kernels.raw_reference, **kw))(
            feats[:rows], feats.T, 0, 0)
    decode = lambda r: kernels.decode_raw(r, None, 0, mass[:rows],
                                          "reference")
    span = kernels.MAX_LANE_TERMS * kernels.DEFAULT_TILE_J
    print(f"  reference, 2-D, {rows} rows x N={n}, {-(-n // span)} j spans "
          f"of at most {span} (kernel compile+run {t_kern:.1f} s):")
    gate_accumulators(decode(raw), decode(ref), "reference")


def gate_accumulators(a, b, mode: str) -> None:
    """tests/test_kernels.py's gates on kernel (a) vs oracle (b)."""
    gate("force, max|d| / max|force|", rel_err(a.force, b.force), 1e-5)
    if mode == "reference":
        gate("gained_mass, elementwise rel",
             elementwise_rel_err(a.gained_mass, b.gained_mass), 1e-6)
        gate("gained_radius, elementwise rel",
             elementwise_rel_err(a.gained_radius, b.gained_radius), 1e-6)
        n_diff = int(np.sum(np.asarray(a.died) != np.asarray(b.died)))
        print(f"    died: {int(np.sum(np.asarray(b.died)))} bodies, "
              f"{n_diff} differ (gate 0)")
        check(n_diff == 0, "died sets differ")
    if mode == "momentum":
        par_a, par_b = np.asarray(a.parent), np.asarray(b.parent)
        n_diff = int(np.sum(par_a != par_b))
        n_merge = int(np.sum(par_b != np.arange(par_b.shape[0])))
        print(f"    parent: {n_merge} bodies merge into another, {n_diff} "
              f"differ (gate 0)")
        check(n_diff == 0, "parent ids differ")
    if mode == "elastic":
        check(float(np.abs(np.asarray(b.dv)).max()) > 0,
              "no elastic impulse fired")
        gate("dv, max|d| / max|dv|", rel_err(a.dv, b.dv), 1e-5)


def phase_golden() -> None:
    """tests/test_golden.py's external-oracle gates at N=1,024."""
    with np.load(os.path.join(ROOT, "tests", "golden", "ref_n1k.npz")) as z:
        gpos, gvel, gmass = z["pos"], z["vel"], z["mass"]
    field = 100_000                    # the fixture's field
    cfg = SimConfig(particle_count=1024, field_width=field,
                    field_height=field, timestep=0.2, seed=1024,
                    backend="auto")
    p = PhysicsParams.from_config(cfg)
    check(resolve_backend(cfg.backend) == "pallas", "auto did not pick "
          "the kernel")
    step = make_step(p, accum_fn=build_accum_fn(cfg.backend, p))
    state = init_scene(cfg)
    worst_pos = worst_vel = 0.0
    for s in range(1, gpos.shape[0]):
        state = step(state)
        mass = np.asarray(state.mass)
        check(np.array_equal(mass > 0, gmass[s] > 0),
              f"alive mask diverged at step {s}")
        check(np.allclose(mass, gmass[s], rtol=1e-6, atol=0),
              f"mass diverged at step {s}")
        alive = (mass > 0)[:, None]
        worst_pos = max(worst_pos, float(np.abs(np.where(
            alive, np.asarray(state.pos) - gpos[s], 0)).max()))
        worst_vel = max(worst_vel, float(np.abs(np.where(
            alive, np.asarray(state.vel) - gvel[s], 0)).max()))
    print(f"  {gpos.shape[0] - 1} steps; alive masks and masses equal at "
          f"every step; {int(np.sum(gmass[-1] > 0))} alive at the end")
    gate("max |pos - oracle| / field", worst_pos / field, 2e-4)
    gate("max |vel - oracle| / field", worst_vel / field, 2e-4)


def phase_cli() -> None:
    from nbodyax import cli
    src = os.path.join(ROOT, "examples", "reference_default.txt")
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(src, tmp)
        here = os.getcwd()
        out = io.StringIO()
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["--config", "reference_default.txt",
                               "--set", "logPath=metrics.jsonl"])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(here)
        check(rc == 0, f"cli exited {rc}")
        taken = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("Time taken:")]
        check(len(taken) == 1, "no 'Time taken:' line")
        print(f"  {taken[0]} (cli.main wall {wall:.1f} s)")
        frames = sorted(os.listdir(os.path.join(tmp, "iter_img")))
        header = b"P5\n1024 1024\n255\n"
        for f in frames:
            with open(os.path.join(tmp, "iter_img", f), "rb") as fh:
                data = fh.read()
            check(data.startswith(header)
                  and len(data) == len(header) + 1024 * 1024,
                  f"frame {f} is not a 1024x1024 P5 image")
        print(f"  frames: {len(frames)} valid P5 images")
        check(len(frames) == 200, f"expected 200 frames, got {len(frames)}")
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
        last = rows[-1]
        print(f"  last log row: step {last['step']}, alive {last['alive']}, "
              f"steps/s {last['steps_per_sec']:.1f}")
        check(last["step"] == 2000, "run did not reach step 2000")
        check(last["alive"] < 16384, "no body merged")
        check(all(np.isfinite(v) for v in last.values()
                  if isinstance(v, (int, float))), "non-finite metrics")


def run_quiet(cfg: SimConfig):
    from nbodyax.driver import run_simulation
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cfg, save_images=False,
                                  log_path=os.path.join(tmp, "m.jsonl"))
        res = run_simulation(cfg, quiet=True)
        with open(cfg.log_path) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
    for leaf in (res.state.pos, res.state.vel, res.state.mass):
        check(bool(np.isfinite(np.asarray(leaf)).all()), "non-finite state")
    return res, rows[-1]


def phase_off_main_path() -> None:
    cfg = SimConfig(particle_count=262_144, force_model="bh",
                    total_iterations=3, log_every=3)
    res, last = run_quiet(cfg)
    print(f"  bh, N=262144, 3 steps: finite, alive {last['alive']}, "
          f"bh_overflow {last['bh_overflow']} (gate 0)")
    check(last["bh_overflow"] == 0, "bh overflow")
    for mode in ("momentum", "elastic"):
        cfg = SimConfig(particle_count=16_384, collision_mode=mode,
                        total_iterations=10, log_every=10)
        res, last = run_quiet(cfg)
        print(f"  {mode}, exact, N=16384, 10 steps: finite, alive "
              f"{last['alive']}")

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from shooting_gradient import build_problem
    grads = {}
    for backend in ("auto", "jnp"):
        miss, v0 = build_problem(n=1024, backend=backend)
        grads[backend] = np.asarray(jax.jit(jax.grad(miss))(v0))
    print(f"  shooting gradient, N=1024: auto {grads['auto']}, "
          f"jnp {grads['jnp']}")
    gate("grad, max|d| / max|grad|", rel_err(grads["auto"], grads["jnp"]),
         1e-5)


def _on_four_cards(state, n_cards: int) -> None:
    devs = {d for leaf in (state.pos, state.mass)
            for d in leaf.sharding.device_set}
    check(len(devs) == n_cards, f"state lives on {len(devs)} devices")


def phase_four_cards() -> None:
    from nbodyax.driver import build_step, resolve_bh_config
    from nbodyax.sharding.mesh import make_mesh, pad_to_shards, shard_state
    mesh = make_mesh(4)
    print(f"  mesh: {[d.id for d in mesh.devices.flat]}")

    # tests/test_ring.py's tolerances; its absolute terms scaled from that
    # test's field (1000) and velocity span (3) to this scene's
    cfg = SimConfig(particle_count=262_144, collision_mode="reference",
                    shards=4)
    st = init_scene(cfg, parity=False)
    st = st._replace(vel=random_bodies(cfg.particle_count, 2, 1)[1])
    one = dataclasses.replace(cfg, shards=1)
    b = build_step(one)(st)
    a = build_step(cfg)(shard_state(pad_to_shards(st, 4), mesh))
    _on_four_cards(a, 4)
    vscale = float(np.abs(np.asarray(b.vel)).max()) / 3.0
    print(f"  ring, shards=4, exact reference, N=262144, 1 step:")
    _compare_states(a, b, pos_atol=1e-4 * FIELD / 1000,
                    vel_atol=1e-4 * vscale, rtol=1e-5)

    # tests/test_sharded_bh.py's tolerances, scaled from its field (2000)
    cfg = SimConfig(particle_count=1_048_576, force_model="bh", shards=4)
    st = init_scene(cfg, parity=False)
    cfg = resolve_bh_config(cfg, state=st)
    b = build_step(dataclasses.replace(cfg, shards=1))(st)
    a = build_step(cfg)(shard_state(pad_to_shards(st, 4), mesh))
    _on_four_cards(a, 4)
    print(f"  sharded bh, shards=4, N=1048576, 1 step (bhLevels="
          f"{cfg.bh_levels}, bhNear={cfg.bh_near}, "
          f"bhNeighborK={cfg.bh_neighbor_k}):")
    vscale = float(np.abs(np.asarray(b.vel)).max()) / 3.0
    _compare_states(a, b, pos_atol=1e-3 * FIELD / 2000,
                    vel_atol=1e-3 * max(vscale, 1.0), rtol=1e-5)


def _compare_states(a, b, *, pos_atol, vel_atol, rtol):
    ma, mb = np.asarray(a.mass)[:b.mass.shape[0]], np.asarray(b.mass)
    n_diff = int(np.sum((ma > 0) != (mb > 0)))
    print(f"    alive: {int(np.sum(mb > 0))}, {n_diff} differ (gate 0)")
    check(n_diff == 0, "alive sets differ")
    gate("mass, elementwise rel", elementwise_rel_err(ma, mb), 1e-6)
    for name, atol in (("pos", pos_atol), ("vel", vel_atol)):
        x = np.asarray(getattr(a, name))[:b.pos.shape[0]]
        y = np.asarray(getattr(b, name))
        excess = float(np.max(np.abs(x - y) - rtol * np.abs(y)))
        print(f"    {name}: max(|d| - {rtol:.0e}*|ref|) = {excess:.3e} "
              f"(gate atol {atol:.3e})")
        check(excess <= atol, f"{name} differs beyond tolerance")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card ring and sharded-bh checks")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    phases = [("device", lambda: phase_device(count))]
    if args.four_cards:
        phases.append(("four cards", phase_four_cards))
    else:
        phases += [("kernel vs oracle", phase_kernel),
                   ("external oracle", phase_golden),
                   ("main path (CLI)", phase_cli),
                   ("off-main-path engines", phase_off_main_path)]
    for i, (name, fn) in enumerate(phases, 1):
        print(f"phase {i}: {name}", flush=True)
        t0 = time.perf_counter()
        fn()
        print(f"phase {i} passed in {time.perf_counter() - t0:.1f} s",
              flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
